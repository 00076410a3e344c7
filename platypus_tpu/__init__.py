"""platypus-tpu: a haplotype-based variant caller on JAX, for the GPU.

A from-scratch reimplementation of the capabilities of Platypus
(andyrimmer/Platypus) on JAX/XLA: host-side I/O and candidate
generation feed fixed-shape batched tensors into device kernels for pair
alignment, genotype likelihoods and EM haplotype-frequency inference.
"""

__version__ = "0.1.0"

# Keep large NumPy buffers on the reusable brk heap instead of fresh mmaps —
# decisive on lazily-paged VMs, harmless elsewhere (see utils/hostmem.py).
from .utils.hostmem import tune_malloc as _tune_malloc

_tune_malloc()
del _tune_malloc
