from calitas_tpu_torch.align.alignment import Alignment, padded_strings
from calitas_tpu_torch.align.guide_alignment import GuideAlignment
from calitas_tpu_torch.align.engine import SequentialAligner

__all__ = ["Alignment", "padded_strings", "GuideAlignment", "SequentialAligner"]
