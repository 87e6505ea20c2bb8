"""The benchmark's plain reference: 3D Gaussian Splatting's forward render
in plain PyTorch.

It imports nothing of the measured package and takes nothing the package
made: it projects, orders and composites the benchmark's own weights again
(``render``). It computes in blocks of tiles on the device it is given, in
float32 with TF32 off unless a lower precision is asked for (the control).
"""
