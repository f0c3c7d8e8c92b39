"""The plain reference of the benchmark's cells: MobileNetV3-Large and EfficientNet-B0 from their
papers' tables, their train step and eval forward in float32 with TF32 off, the controls of the
comparison and the numbers compared. It imports torch and numpy alone: nothing of the program."""
