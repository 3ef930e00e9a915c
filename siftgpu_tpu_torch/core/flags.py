"""SiftGPU command-line flags -> `SiftConfig` overrides (`SiftGPU::ParseParam`).

Port of `siftgpu_tpu/core/flags.py`: the same flags, the same dict.
`parse_flags` mutates no global state; it returns the overrides that
`SiftTPU` turns into a `SiftConfig`.

Supported (flag -> field):
  -fo <n>      first_octave (-1 = 2x upsample; n>0 = start 2^n-downsampled)
  -d <n>       dog_levels
  -t <x>       dog_threshold
  -e <x>       edge_threshold
  -m [<n>]     max_orientations (bare -m => 2)
  -s [<0|1>]   subpixel (bare -s => on)
  -f <x>       kernel_truncate (filter width factor, default 4)
  -maxd <n>    max_dim (pre-downsample cap)
  -tc/-tc3 <n> max_keypoints, truncation by response (truncate_method 0)
  -tc1 <n>     max_keypoints, prefer fine octaves   (truncate_method 1)
  -tc2 <n>     max_keypoints, prefer coarse octaves (truncate_method 2)
  -obo         process_obo (octave-by-octave extraction)
  -loweo       lowe_origin (+0.5 pixel origin)
  -unn         unnormalized descriptors
  -sign        keep_sign
  -i <path>    input image (stored under "_input_image")
  -il <path>   image-list file, one path per line (stored under "_image_list";
               SiftTPU.run_sift() with no argument consumes the next entry)
  -o <path>    output file (stored under "_output_file")
  -b           binary output (stored under "_output_binary")
  -p <WxH>     warm-up size (stored under "_prealloc" as (height, width);
               SiftTPU.create_context runs the path once at that size)
  -v <n>       verbosity (stored under "_verbose")
Unknown flags are collected under "_unknown" (SiftGPU ignores them).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

__all__ = ["parse_flags"]


def _parse_wh(v: str):
    """'WxH' -> (height, width) (SiftGPU's -p order is WxH)."""
    w, h = v.lower().split("x")
    return (int(h), int(w))


_VALUED = {
    "-fo": ("first_octave", int),
    "-d": ("dog_levels", int),
    "-t": ("dog_threshold", float),
    "-e": ("edge_threshold", float),
    "-f": ("kernel_truncate", float),
    "-maxd": ("max_dim", int),
    "-i": ("_input_image", str),
    "-il": ("_image_list", str),
    "-o": ("_output_file", str),
    "-p": ("_prealloc", _parse_wh),
    "-v": ("_verbose", int),
}

_OPTIONAL_VALUED = {
    # SiftGPU caps orientations at 2 (GlobalUtil::_MaxOrientation)
    "-m": ("max_orientations", lambda v: max(1, min(int(v), 2)), 2),
    "-s": ("subpixel", lambda v: bool(int(v)), True),
}

# -tc/-tc1/-tc2/-tc3 all set the feature cap; the suffix selects the
# truncation preference (SiftConfig.truncate_method): -tc/-tc3 -> 0 (by
# response), -tc1 -> 1 (fine octaves first), -tc2 -> 2 (coarse octaves first).
_TC = {"-tc": 0, "-tc1": 1, "-tc2": 2, "-tc3": 0}

_BOOL = {
    "-loweo": ("lowe_origin", True),
    "-unn": ("unnormalized", True),
    "-obo": ("process_obo", True),
    "-sign": ("keep_sign", True),
    "-b": ("_output_binary", True),
    # SiftGPU's backend-selection flags: accepted and ignored (the route
    # follows the tensors' device)
    "-cuda": (None, None),
    "-glsl": (None, None),
    "-cl": (None, None),
    "-pack": (None, None),
    "-unpack": (None, None),
    "-lcpu": (None, None),
    "-noprep": (None, None),
    "-tight": (None, None),
    "-exit": (None, None),
}


def parse_flags(argv: Sequence[str]) -> Dict:
    out: Dict = {}
    unknown: List[str] = []
    i = 0
    argv = list(argv)
    while i < len(argv):
        a = argv[i]
        base = a.split("=")[0]
        if base in _VALUED:
            field, conv = _VALUED[base]
            if "=" in a:
                out[field] = conv(a.split("=", 1)[1])
            else:
                i += 1
                out[field] = conv(argv[i])
        elif base in _TC:
            if "=" in a:
                out["max_keypoints"] = int(a.split("=", 1)[1])
            else:
                i += 1
                out["max_keypoints"] = int(argv[i])
            out["truncate_method"] = _TC[base]
        elif base in _OPTIONAL_VALUED:
            field, conv, default = _OPTIONAL_VALUED[base]
            if "=" in a:
                out[field] = conv(a.split("=", 1)[1])
            else:
                # the value is optional: consume the next token iff it parses
                # (negatives included); otherwise the default applies and the
                # token is left for the main loop (SiftGPU's sscanf)
                nxt = argv[i + 1] if i + 1 < len(argv) else None
                val = None
                if nxt is not None:
                    try:
                        val = conv(nxt)
                    except (TypeError, ValueError):
                        val = None
                if val is not None:
                    i += 1
                    out[field] = val
                else:
                    out[field] = default
        elif base in _BOOL:
            field, val = _BOOL[base]
            if field:
                out[field] = val
        else:
            unknown.append(a)
        i += 1
    if unknown:
        out["_unknown"] = unknown
    return out
