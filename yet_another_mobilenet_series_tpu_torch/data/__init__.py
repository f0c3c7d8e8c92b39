"""Input pipelines of the port: the fake dataset and the synthetic loader,
generated on the device, and the corrupt-record resilience layer
(``pipeline.py``)."""
