from .aligner import Pseudoaligner, ReadRecord

__all__ = ["Pseudoaligner", "ReadRecord"]
