from .image import IndexImage
from .builder import build_index
from .mphf import Mphf, build_mphf

__all__ = ["IndexImage", "build_index", "Mphf", "build_mphf"]
