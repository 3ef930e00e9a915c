"""siftgpu_tpu_torch: the PyTorch / CUDA port of `siftgpu_tpu`.

The SIFT extract + match main path (pyramid -> detect -> orient + describe ->
top-K, then uint8 best-2 matching) on PyTorch tensors, the SiftGPU /
SiftMatchGPU-style facade (`SiftTPU`, `SiftMatchTPU`: flags, file IO,
descriptor-only mode, guided matching), two-view SfM and the SLAM loop
(`pipeline.slam.run_slam`).  The route follows the
device of the input: CUDA tensors run the hand-written Hopper kernels of
`csrc/` (built with nvcc at first use), CPU tensors their plain PyTorch
versions.  This package imports neither JAX nor `siftgpu_tpu`.
"""

from .core.config import MatchConfig, SiftConfig
from .frontend.extract import Features, extract_features, extract_features_jit
from .frontend.match import MatchResult, match_descriptors, match_descriptors_batch
from .pipeline.api import SiftMatchTPU, SiftTPU

__version__ = "0.1.0"

__all__ = [
    "SiftConfig", "MatchConfig", "Features", "extract_features", "extract_features_jit",
    "MatchResult", "match_descriptors", "match_descriptors_batch",
    "SiftTPU", "SiftMatchTPU",
]
