"""The benchmark's plain reference: the renderer's arithmetic in plain
PyTorch and NumPy, written down from the reference engine's description
and independent of the package under test (it imports nothing of it)."""
