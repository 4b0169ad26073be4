from calitas_tpu_torch.core.sequence import (
    IUPAC_MASK,
    compatible,
    complement_char,
    encode_query,
    encode_target,
    revcomp,
    revcomp_bytes,
)
from calitas_tpu_torch.core.cigar import Cigar, CigarElem
from calitas_tpu_torch.core.scoring import Defaults, Scorer, derive_scorer
from calitas_tpu_torch.core.guide import Guide

__all__ = [
    "IUPAC_MASK",
    "compatible",
    "complement_char",
    "encode_query",
    "encode_target",
    "revcomp",
    "revcomp_bytes",
    "Cigar",
    "CigarElem",
    "Defaults",
    "Scorer",
    "derive_scorer",
    "Guide",
]
