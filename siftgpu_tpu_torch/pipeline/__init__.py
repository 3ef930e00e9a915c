from . import api, siftio
from .api import SiftMatchTPU, SiftTPU

__all__ = ["api", "siftio", "SiftTPU", "SiftMatchTPU"]
