"""Plain PyTorch reference of one gsgen training step (render, VAE, UNet,
SDS / VSD, Adam), for the benchmark's correctness check.

Nothing here imports the program under test: the networks, the
renderer, the camera sampler and the optimizer are written out again in
textbook form (dense compositing, plain softmax attention), in fp32 with
TF32 off unless a :class:`.quant.Precision` lowers the operands of every
matrix product and convolution (the check's control).
"""
