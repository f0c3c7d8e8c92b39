"""Input pipelines of the port: the fake dataset and the synthetic loader,
generated on the device (``pipeline.py``)."""
