"""Hand-written CUDA kernels (`csrc/*.cu`), their launchers, their plain
PyTorch versions (`ref.py`) and the engine-facing wrappers (`ops.py`)."""
