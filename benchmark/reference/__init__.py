"""The plain reference the benchmark holds the port against.

Straightforward PyTorch of the same mathematics as the port's training
steps: the geometry, the 10-channel compositing (a dense per-tile walk, no
kernels, no chunked layout), the losses, the strand networks and the
optimizers.  Nothing here imports the port, JAX or the JAX package; the
benchmark hands both sides the same inputs and weights, and this side works
out everything the port's set-up derives from them again.  Most of it is a
frozen copy of the port's plain code, so that a later change to the port
cannot move the yardstick.
"""
