"""The Guide model: protospacer + optional PAM(s), parsed from mixed case.

Parity contract (SequentialGuideAligner.scala:32-122; SURVEY.md §2.1):
  - a guide string mixes case: protospacer upper, PAM lower;
  - ``split_by_case`` splits into runs of same case; >2 runs is an error;
    all-lowercase is an error;
  - PAM position inferred from which run is lowercase: leading lower -> 5'
    PAM, trailing lower -> 3' PAM;
  - auxiliary PAMs require a primary PAM and must be lowercase; all PAMs
    share the primary PAM's end;
  - normalization: guide -> uppercase, PAMs -> lowercase;
  - derived: protospacer_length, pam_length = max PAM length,
    length = protospacer + max PAM; fw and revcomp byte arrays precomputed.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Sequence

from calitas_tpu_torch.core.sequence import revcomp


@dataclass(frozen=True)
class Guide:
    guide: str
    pams_3prime: tuple[str, ...] = ()
    pams_5prime: tuple[str, ...] = ()

    def __post_init__(self) -> None:
        if self.pams_3prime and self.pams_5prime:
            raise ValueError("Guide cannot have both 3' and 5' PAMs.")

    @property
    def pam_is_5prime(self) -> bool:
        return bool(self.pams_5prime)

    @property
    def pam_is_3prime(self) -> bool:
        return bool(self.pams_3prime)

    @property
    def pams(self) -> tuple[str, ...]:
        return self.pams_5prime if self.pam_is_5prime else self.pams_3prime

    @property
    def guide_fw(self) -> str:
        return self.guide

    @property
    def guide_rc(self) -> str:
        return revcomp(self.guide)

    @property
    def pams_fw(self) -> tuple[str, ...]:
        return self.pams

    @property
    def pams_rc(self) -> tuple[str, ...]:
        return tuple(revcomp(p) for p in self.pams)

    @property
    def protospacer_length(self) -> int:
        return len(self.guide)

    @property
    def pam_length(self) -> int:
        """The maximum length of the PAM for this guide."""
        return max((len(p) for p in self.pams), default=0)

    @property
    def length(self) -> int:
        """Protospacer + longest PAM."""
        return self.protospacer_length + self.pam_length

    # -- construction -------------------------------------------------------

    @staticmethod
    def of(
        guide: str,
        pams_3prime: Sequence[str] = (),
        pams_5prime: Sequence[str] = (),
    ) -> "Guide":
        """Construct, forcing case (guide upper, PAMs lower) —
        SequentialGuideAligner.scala:62-68."""
        return Guide(
            guide=guide.upper(),
            pams_3prime=tuple(p.lower() for p in pams_3prime),
            pams_5prime=tuple(p.lower() for p in pams_5prime),
        )

    @staticmethod
    def parse(sequence: str, aux_pams: Iterable[str] = ()) -> "Guide":
        """Parse a mixed-case guide(+PAM) string, with optional auxiliary
        PAMs — SequentialGuideAligner.scala:81-107."""
        aux = list(aux_pams)
        parts = split_by_case(sequence.strip())
        if not parts:
            raise ValueError(f"Invalid Guide sequence {sequence!r}.")
        if len(parts) > 2:
            raise ValueError(f"Invalid Guide sequence {sequence}.")
        if not (len(parts) == 2 or parts[0][0].isupper()):
            raise ValueError("Guide sequence cannot be all lower case.")
        if aux and len(parts) != 2:
            raise ValueError(
                "Cannot provide auxiliary PAMs without providing a PAM in the "
                "guide sequence."
            )
        for p in aux:
            if p != p.lower():
                raise ValueError(
                    f"All PAMs must be lower case. PAMs given: {', '.join(aux)}"
                )

        if len(parts) == 1:
            guide, pam, five, three = parts[0], None, False, False
        elif parts[0][0].isupper():
            guide, pam, five, three = parts[0], parts[1], False, True
        else:
            guide, pam, five, three = parts[1], parts[0], True, False

        pams = ([pam] if pam is not None else []) + aux
        return Guide.of(
            guide=guide,
            pams_3prime=pams if three else (),
            pams_5prime=pams if five else (),
        )


def split_by_case(bases: str) -> list[str]:
    """Split a string into contiguous chunks of the same case
    (SequentialGuideAligner.scala:110-121)."""
    chunks: list[str] = []
    i = 0
    n = len(bases)
    while i < n:
        first_lower = bases[i].islower()
        j = i
        while j < n and bases[j].islower() == first_lower:
            j += 1
        chunks.append(bases[i:j])
        i = j
    return chunks
