"""The plain reference the benchmark judges the program by: plain PyTorch
in f32 with TF32 off, importing nothing of the program (`model.py`)."""
