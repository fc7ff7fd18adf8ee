"""The benchmark's plain reference: what a frame and a training step of the
3DGS rasterizer with StopThePop's sort modes compute, in plain PyTorch.

It imports no module of the measured program (``stopthepop_tpu_torch``), nor
JAX, nor the JAX package. Where it follows the program's own plain versions
operation for operation, it is a frozen copy of them, so that a later change
to the program cannot move the yardstick. It works everything out again from
the inputs the benchmark makes (scene, cameras, targets): the preprocess,
the pairs and their order, the blend, the loss, the gradients and Adam.

Precision: ``lowp=True`` computes the per-Gaussian preprocess (forward and
backward) in bfloat16 and rounds its outputs and the gradients to it: the
control that a comparison has to fail.
"""
