"""KataCoffee in PyTorch and CUDA: the port of `katacoffee_tpu` to one
NVIDIA H100.

The subpackages mirror the JAX package's (`game/`, `nn/`, `ops/`, `search/`,
`dataio/`, `command/`) so each module's counterpart is found by its path.
The port imports torch and numpy only: nothing of JAX, flax or
`katacoffee_tpu`. Entry points run on `cuda` unless the caller passes
`device="cpu"`; the search's child-stats gather is a hand-written CUDA kernel
(`ops/gather_kernel.cu`) on the card and plain torch indexing on the CPU.
"""

__version__ = "0.1.0"
