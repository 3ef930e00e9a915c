"""Sizes of the CPU tests."""

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# each cell at a size a CPU test holds: every width and shape parameter as
# the configuration states it but the image size, K and the ring
# (colmap-extract's K binds, so that -tc2's truncation is exercised)
SMALL = {
    "vga-stream": {"config": {"sift": {"height": 96, "width": 128, "max_keypoints": 256},
                              "match": {"max_sift": 256, "max_match": 256}},
                   "traffic": {"ring": 16, "check_calls": 2}},
    "vga-frame": {"config": {"sift": {"height": 96, "width": 128, "max_keypoints": 256},
                             "match": {"max_sift": 256, "max_match": 256}},
                  "traffic": {"ring": 16, "check_calls": 3}},
    "colmap-extract": {"config": {"sift": {"height": 107, "width": 160, "max_keypoints": 96}},
                       "traffic": {"ring": 4, "check_calls": 2}},
    "colmap-exhaustive": {"config": {"sift": {"max_keypoints": 256},
                                     "match": {"max_sift": 256, "max_match": 256}},
                          "traffic": {"sets": 8, "pairs_per_call": 7, "check_calls": 2}},
}
