"""Class-based API of SiftGPU / SiftMatchGPU on the PyTorch port.

Port of `siftgpu_tpu/pipeline/api.py`: the same classes, methods and codes,
so one script runs against either package.

  SiftGPU::ParseParam             -> SiftTPU.parse_param (same flag names)
  SiftGPU::CreateContextGL        -> SiftTPU.create_context
  SiftGPU::VerifyContextGL        -> SiftTPU.verify_context
  SiftGPU::RunSIFT(file|data)     -> SiftTPU.run_sift
  SiftGPU::GetFeatureNum          -> SiftTPU.get_feature_num
  SiftGPU::GetFeatureVector       -> SiftTPU.get_feature_vector
  SiftGPU::SetKeypointList        -> SiftTPU.set_keypoint_list (descriptor-only)
  SiftGPU::SaveSIFT               -> SiftTPU.save_sift
  SiftMatchGPU::SetMaxSift        -> SiftMatchTPU(max_sift=...)
  SiftMatchGPU::SetDescriptors    -> SiftMatchTPU.set_descriptors
  SiftMatchGPU::SetFeautreLocation-> SiftMatchTPU.set_feature_location [sic]
  SiftMatchGPU::GetSiftMatch      -> SiftMatchTPU.get_sift_match
  SiftMatchGPU::GetGuidedSiftMatch-> SiftMatchTPU.get_guided_sift_match
  CreateNewSiftGPU / CreateNewSiftMatchGPU -> module-level factory functions

The device is explicit: every class and factory takes `device=` (default
"cuda") and every tensor goes there.  A CUDA device without a card makes
`create_context` / `verify_context` return `SIFTGPU_NOT_SUPPORTED` and
`run_sift` raise; nothing moves to the CPU on its own.  `device="cpu"` runs
the plain PyTorch versions of the kernels.

Where the reference calls a compiled program, the facade calls a captured
entry point (`core/graphs.py`): `run_sift` the facade's
`extract_features_jit` (with -obo, `extract.extract_features_obo_jit`,
whose three programs share -obo's family), `create_context` with `-p WxH`
the same entry point at that size, so its capture exists before the first
`run_sift` (the reference pre-compiles there), `run_sift_with_keypoints`
`describe_at_keypoints_jit` (one capture per power of two of keypoint
counts, below), and the matchers
`match_descriptors_jit` and `guided_match_descriptors_jit` (`hdist_max`,
`fdist_max` and the config keyed by value, H and F by whether they are
None).  On CUDA tensors the first call of a signature captures it (two
warm-up calls and the capture: the counterpart of the reference's
compile, which `-v 1`'s time includes), later calls replay; on CPU
tensors they call the eager functions.  Nothing switches capture off.

The facade's four entry points are one `GraphFamily` (`FACADE`): one pool
a device for every signature held, since no two of them replay at once.
The family holds at most `MAX_CAPTURES` captures a device, of every entry
point, image size, config and match setting together: a call with a new
signature past that first drops the least recently used capture there,
under the family's lock (`GraphFamily.make_room`).  -obo's programs are
bounded the same way in their own family (`extract.OBO_CAPTURES`).
Descriptor-only mode pads the keypoint list with invalid rows (sigma 0)
to a power of two (at least `DESCRIBE_MIN_ROWS`) and keeps the first N
rows: each keypoint is described alone, so those rows are the bits of a
call on the N keypoints, and a list of any length replays one of a few
captures where the reference's jit retraces for each N.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import image as imio
from ..core.config import MatchConfig, SiftConfig
from ..core.flags import parse_flags
from ..core.graphs import GraphFamily, graphed
from ..frontend.extract import (OBO_FAMILY, Features, extract_features,
                                extract_features_obo_jit)
from ..frontend.match import guided_match_descriptors, match_descriptors
from ..frontend.redetect import describe_at_keypoints
from . import profile, siftio

__all__ = [
    "SIFTGPU_FULL_SUPPORTED", "SIFTGPU_NOT_SUPPORTED",
    "SiftTPU", "SiftMatchTPU", "ComboSiftTPU",
    "create_new_sift_tpu", "create_new_sift_match_tpu", "release_captures",
]

SIFTGPU_FULL_SUPPORTED = 2   # VerifyContextGL return codes
SIFTGPU_NOT_SUPPORTED = 0

# captures the facade holds a device.  The pool is shared, so it holds the
# largest working set once; each further capture adds its static inputs,
# outputs and the pool's fragmentation (30-40 MiB an image size up to
# 1088x1920 on an H100, less for describe and the matchers: chip_smoke.py
# phase 4b logs it), so 15 beside the largest add about 0.6 GiB at most.
# A signature dropped and called again pays its capture (4x an eager call).
MAX_CAPTURES = 16
DESCRIBE_MIN_ROWS = 128   # the smallest keypoint count describe captures

# the reference's compiled programs that the facade calls, captured on
# CUDA inputs into one pool a device (see the module's docstring)
FACADE = GraphFamily("facade", limit=MAX_CAPTURES)
extract_features_jit = graphed(extract_features, "facade extract_features_jit", FACADE)
describe_at_keypoints_jit = graphed(describe_at_keypoints, "facade describe_at_keypoints_jit",
                                    FACADE)
match_descriptors_jit = graphed(match_descriptors, "facade match_descriptors_jit", FACADE)
guided_match_descriptors_jit = graphed(guided_match_descriptors,
                                       "facade guided_match_descriptors_jit", FACADE)


def release_captures() -> None:
    """Drop every capture of the facade and of -obo, on every device."""
    FACADE.release()
    OBO_FAMILY.release()


def describe_rows(n: int) -> int:
    """The keypoint count describe runs for a list of `n`: a power of two,
    at least `DESCRIBE_MIN_ROWS`."""
    return max(DESCRIBE_MIN_ROWS, 1 << max(n - 1, 0).bit_length())


def _supported(device: torch.device) -> bool:
    return device.type != "cuda" or torch.cuda.is_available()


def _require(device: torch.device) -> None:
    if not _supported(device):
        raise RuntimeError(f"device {device} is not available (torch.cuda.is_available() "
                           "is False); pass device='cpu' to run on the CPU")


class SiftTPU:
    """Stateful facade over the functional extraction pipeline."""

    def __init__(self, argv: Optional[Sequence[str]] = None, device="cuda", **config_kw):
        self.device = torch.device(device)
        self._overrides = dict(config_kw)
        self._cfg: Optional[SiftConfig] = None
        self._feats = None
        self._image = None
        self._keypoint_list = None
        self._list_iter = None
        self._run_index = 0
        if argv:
            self.parse_param(argv)

    # -- configuration ----------------------------------------------------
    def parse_param(self, argv: Sequence[str]) -> None:
        """SiftGPU-flag-compatible parser (-fo, -d, -t, -e, -m, -s, ...)."""
        new = parse_flags(argv)
        self._overrides.update(new)
        self._cfg = None
        if "_image_list" in new:
            self._list_iter = None  # restart the -il list

    def config_for(self, height: int, width: int) -> SiftConfig:
        kw = {k: v for k, v in self._overrides.items() if not k.startswith("_")}
        maxd = kw.pop("max_dim", 0)
        if maxd:
            while max(height, width) > maxd:
                height //= 2
                width //= 2
        return SiftConfig(height=height, width=width, **kw)

    def _images(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr[None])).to(self.device)

    def _extract(self, arr: np.ndarray, cfg: SiftConfig):
        images = self._images(arr)
        if cfg.process_obo:  # -obo: one octave at a time
            return extract_features_obo_jit(images, cfg)
        return extract_features_jit(images, cfg)

    # -- context ----------------------------------------------------------
    def create_context(self) -> int:
        """The CreateContextGL analog: check that the device exists; with
        `-p WxH` also run the extraction once at that size, which builds
        the kernels and, on a card, captures the program that `run_sift`
        replays at that size (SiftGPU's pyramid pre-allocation)."""
        if not _supported(self.device):
            return SIFTGPU_NOT_SUPPORTED
        pre = self._overrides.get("_prealloc")
        if pre:
            cfg = self.config_for(*pre)
            self._extract(np.zeros((cfg.height, cfg.width), np.float32), cfg)
        return SIFTGPU_FULL_SUPPORTED

    verify_context = create_context

    def _next_listed_image(self):
        """-il: RunSIFT() with no argument consumes the next path of the list."""
        if self._list_iter is None:
            path = self._overrides.get("_image_list")
            if not path:
                raise ValueError("run_sift() without an image needs -il <list>")
            with open(path) as f:
                entries = [ln.strip() for ln in f if ln.strip()]
            self._list_iter = iter(entries)
        return next(self._list_iter, None)

    @staticmethod
    def _load(image) -> np.ndarray:
        if isinstance(image, (str, bytes)):
            return imio.load_image(image)
        return imio.to_grayscale(np.asarray(image))

    # -- extraction -------------------------------------------------------
    def run_sift(self, image=None, *_ignored) -> bool:
        """image: path to an image file, or [H, W] (grayscale) / [H, W, 3]
        (RGB, converted with SiftGPU's luminance weights) array; None
        consumes the next entry of the `-il` image list (returns False when
        the list is exhausted)."""
        _require(self.device)
        if image is None:
            image = self._next_listed_image()
            if image is None:
                return False
        arr = self._load(image)
        maxd = self._overrides.get("max_dim", 0)
        if maxd:
            arr = imio.downsample_to_fit(arr, maxd)
        self._image = arr
        cfg = self.config_for(*arr.shape)
        self._cfg = cfg
        verbose = int(self._overrides.get("_verbose", 0))
        t0 = time.perf_counter()
        self._feats = self._extract(arr, cfg)
        if verbose >= 1:  # -v 1: totals
            n = int(self._feats.count[0])  # waits for the device
            print(f"#features: {n}  time: {(time.perf_counter() - t0) * 1e3:.1f} ms")
        if verbose >= 2:  # -v 2+: the per-stage table, each stage timed apart
            times = profile.profile_extraction(self._images(arr), cfg, iters=1, match_pairs=False)
            print(profile.format_stage_table(times, batch=1))
        out_path = self._overrides.get("_output_file")
        if out_path:
            # -o: save after every RunSIFT; later -il runs get a suffixed path
            self.save_sift(out_path if self._run_index == 0
                           else f"{out_path}.{self._run_index}")
        self._run_index += 1
        return True

    def get_feature_num(self) -> int:
        if self._feats is None:
            return 0
        return int(self._feats.count[0])

    def get_feature_vector(self) -> Tuple[np.ndarray, np.ndarray]:
        """(keys [N, 4] float32 (x, y, sigma, theta), desc [N, 128] uint8) of
        the valid keypoints."""
        if self._feats is None:
            return np.zeros((0, 4), np.float32), np.zeros((0, 128), np.uint8)
        m = self._feats.mask[0].cpu().numpy()
        keys = self._feats.keypoints[0].cpu().numpy()[m]
        desc = self._feats.desc[0].cpu().numpy()[m]
        return keys.astype(np.float32), desc

    def set_keypoint_list(self, keys: np.ndarray) -> None:
        """Descriptor-only mode: `run_sift_with_keypoints` computes descriptors
        at these (x, y, sigma, theta) keypoints (SetKeypointList)."""
        self._keypoint_list = np.asarray(keys, np.float32)

    def run_sift_with_keypoints(self, image) -> bool:
        """RunSIFT with a preset keypoint list (descriptor-only mode)."""
        if self._keypoint_list is None:
            return self.run_sift(image)
        _require(self.device)
        arr = self._load(image)
        cfg = self.config_for(*arr.shape)
        self._cfg = cfg
        n = len(self._keypoint_list)
        keys = np.zeros((1, describe_rows(n), *self._keypoint_list.shape[1:]), np.float32)
        keys[0, :n] = self._keypoint_list   # the padded rows' sigma 0: no octave
        feats = describe_at_keypoints_jit(self._images(arr), torch.from_numpy(keys).to(self.device),
                                          cfg)
        self._feats = Features(*(t[:, :n] for t in feats))
        return True

    def save_sift(self, path: str, binary: Optional[bool] = None) -> None:
        keys, desc = self.get_feature_vector()
        binary = self._overrides.get("_output_binary", False) if binary is None else binary
        if binary:
            siftio.write_binary_sift(path, keys, desc)
        else:
            siftio.write_lowe_ascii(path, keys, desc)


class SiftMatchTPU:
    """SiftMatchGPU facade: set descriptors/locations once, query matches."""

    def __init__(self, max_sift: int = 4096, device="cuda", **match_kw):
        self.device = torch.device(device)
        self.cfg = MatchConfig(max_sift=max_sift, max_match=max_sift, **match_kw)
        self._desc = [None, None]
        self._loc = [None, None]

    def set_max_sift(self, n: int) -> None:
        self.cfg = self.cfg.replace(max_sift=n, max_match=n)

    def verify_context(self) -> int:
        return SIFTGPU_FULL_SUPPORTED if _supported(self.device) else SIFTGPU_NOT_SUPPORTED

    def set_descriptors(self, index: int, descriptors, num: Optional[int] = None):
        d = np.asarray(descriptors)
        if num is not None:
            d = d[:num]
        self._desc[index] = d

    def set_feature_location(self, index: int, keys) -> None:
        """keys: [N, >=2] with (x, y) in the first two columns."""
        self._loc[index] = np.asarray(keys, np.float32)[:, :2]

    # SiftMatchGPU's misspelt name, kept so scripts run unchanged
    SetFeautreLocation = set_feature_location

    def _padded(self, index: int):
        d = self._desc[index]
        if d is None:
            raise ValueError(f"descriptors {index} not set")
        n = self.cfg.max_sift
        out = np.zeros((n, d.shape[1]), d.dtype)
        out[: len(d)] = d[:n]
        mask = np.zeros(n, bool)
        mask[: min(len(d), n)] = True
        return torch.from_numpy(out).to(self.device), torch.from_numpy(mask).to(self.device)

    def get_sift_match(self, max_match: int = 4096, distmax: float = 0.7,
                       ratiomax: float = 0.8, mutual_best: bool = True) -> np.ndarray:
        """[M, 2] int32 index pairs (GetSiftMatch)."""
        _require(self.device)
        cfg = self.cfg.replace(dist_max=distmax, ratio_max=ratiomax, mutual_best=mutual_best)
        d0, m0 = self._padded(0)
        d1, m1 = self._padded(1)
        res = match_descriptors_jit(d0, d1, m0, m1, cfg)
        c = min(int(res.count), max_match)
        return res.pairs[:c].cpu().numpy()

    def get_guided_sift_match(
        self, max_match: int = 4096, H=None, F=None,
        distmax: float = 0.7, ratiomax: float = 0.8,
        hdistmax: float = 32.0, fdistmax: float = 16.0,
        mutual_best: bool = True,
    ) -> np.ndarray:
        """[M, 2] int32 index pairs whose reprojection through H is within
        `hdistmax` px and/or whose symmetric epipolar distance through F is
        within `fdistmax` px (GetGuidedSiftMatch)."""
        _require(self.device)
        cfg = self.cfg.replace(dist_max=distmax, ratio_max=ratiomax, mutual_best=mutual_best)
        d0, m0 = self._padded(0)
        d1, m1 = self._padded(1)
        loc = []
        for i in (0, 1):
            l = self._loc[i]
            if l is None:
                raise ValueError("set_feature_location is required for guided matching")
            out = np.zeros((self.cfg.max_sift, 2), np.float32)
            out[: min(len(l), self.cfg.max_sift)] = l[: self.cfg.max_sift]
            loc.append(torch.from_numpy(out).to(self.device))
        mat = lambda M: None if M is None else torch.as_tensor(
            np.asarray(M, np.float32), device=self.device)
        res = guided_match_descriptors_jit(
            d0, d1, loc[0], loc[1], H=mat(H), F=mat(F), mask0=m0, mask1=m1,
            hdist_max=hdistmax, fdist_max=fdistmax, cfg=cfg)
        c = min(int(res.count), max_match)
        return res.pairs[:c].cpu().numpy()


class ComboSiftTPU:
    """ComboSiftGPU analog: one SiftTPU and one SiftMatchTPU on one device."""

    def __init__(self, argv: Optional[Sequence[str]] = None, max_sift: int = 4096,
                 device="cuda"):
        self.sift = SiftTPU(argv=argv, device=device)
        self.matcher = SiftMatchTPU(max_sift=max_sift, device=device)

    def match_files(self, path0: str, path1: str, **match_kw):
        """Extract both images and match them (the SimpleSIFT flow)."""
        self.sift.run_sift(path0)
        k0, d0 = self.sift.get_feature_vector()
        self.sift.run_sift(path1)
        k1, d1 = self.sift.get_feature_vector()
        self.matcher.set_descriptors(0, d0)
        self.matcher.set_descriptors(1, d1)
        self.matcher.set_feature_location(0, k0)
        self.matcher.set_feature_location(1, k1)
        return k0, k1, self.matcher.get_sift_match(**match_kw)


def create_new_sift_tpu(np_args: Optional[Sequence[str]] = None, device="cuda") -> SiftTPU:
    """CreateNewSiftGPU analog."""
    return SiftTPU(argv=np_args, device=device)


def create_new_sift_match_tpu(max_sift: int = 4096, device="cuda") -> SiftMatchTPU:
    """CreateNewSiftMatchGPU analog."""
    return SiftMatchTPU(max_sift=max_sift, device=device)
