"""The net-cost scoring algebra.

User-facing parameters are *net costs* — the cost of converting a match into
a difference, with the lost match folded in.  They are derived into raw DP
scores exactly as the reference does (SequentialGuideAligner.scala:192-208):

    match_score        =  abs(mismatch_net_cost) // 2
    mismatch_score     = -(abs(mismatch_net_cost) - match_score)
    query_gap_score    = -abs(guide_gap_net_cost)                  # gap in query/guide
    target_gap_score   = -abs(genome_gap_net_cost) + match_score   # gap in target/genome
    pam_match_score    =  abs(pam_mismatch_net_cost) // 2
    pam_mismatch_score = -(abs(pam_mismatch_net_cost) - pam_match_score)

Why the asymmetry: a gap in the *target* leaves a query base
unconsumed-by-match (losing a +match), so raw = net + match; a gap in the
*query* consumes extra target without losing a query match, so raw = net.

Bulge glossary (SequentialGuideAligner.scala:183-191): a gap in the
genome/target is a bulge in the guide; a gap in the guide/query is a bulge
in the genome.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

from calitas_tpu_torch.core.sequence import MASK_TABLE


class Defaults:
    """Default parameters (SequentialGuideAligner.scala:17-28)."""

    MISMATCH_NET_COST = -120
    GUIDE_GAP_NET_COST = -121
    GENOME_GAP_NET_COST = -122
    PAM_MISMATCH_NET_COST = -260

    MAX_GUIDE_DIFFS = 5
    MAX_PAM_MISMATCHES = 1
    MAX_GAPS_BETWEEN_GUIDE_AND_PAM = 3
    MAX_OVERLAP = 10
    MAX_VARIANTS_IN_CLUSTER = 16


@dataclass(frozen=True)
class Scorer:
    """Raw DP scores plus the per-base pairing rule.

    Pairing rules (SequentialGuideAligner.scala:139-147):
      - a lowercase *query* base selects the PAM match/mismatch scores;
      - a target ``N``/``n`` is always a mismatch (even vs a query ``n``);
      - otherwise IUPAC-ambiguity-aware, case-insensitive compatibility.
    """

    match_score: int
    mismatch_score: int
    pam_match_score: int
    pam_mismatch_score: int
    query_gap_score: int
    target_gap_score: int

    def score_pairing(self, query: str, target: str) -> int:
        is_pam = query.islower()
        m = self.pam_match_score if is_pam else self.match_score
        mm = self.pam_mismatch_score if is_pam else self.mismatch_score
        if target in ("N", "n"):
            return mm
        if MASK_TABLE[ord(query)] & MASK_TABLE[ord(target)]:
            return m
        return mm


def derive_scorer(
    mismatch_net_cost: int = Defaults.MISMATCH_NET_COST,
    genome_gap_net_cost: int = Defaults.GENOME_GAP_NET_COST,
    guide_gap_net_cost: int = Defaults.GUIDE_GAP_NET_COST,
    pam_mismatch_net_cost: int = Defaults.PAM_MISMATCH_NET_COST,
) -> Scorer:
    """Derive raw DP scores from net costs (SequentialGuideAligner.scala:192-208)."""
    match_score = abs(mismatch_net_cost) // 2
    mismatch_score = -(abs(mismatch_net_cost) - match_score)
    query_gap_score = -abs(guide_gap_net_cost)
    target_gap_score = -abs(genome_gap_net_cost) + match_score
    pam_match_score = abs(pam_mismatch_net_cost) // 2
    pam_mismatch_score = -(abs(pam_mismatch_net_cost) - pam_match_score)
    return Scorer(
        match_score=match_score,
        mismatch_score=mismatch_score,
        pam_match_score=pam_match_score,
        pam_mismatch_score=pam_mismatch_score,
        query_gap_score=query_gap_score,
        target_gap_score=target_gap_score,
    )


def scorer_from_reference(params: dict) -> Scorer:
    """The port's :class:`Scorer` from another scorer's fields given as
    plain ints (or 0-d numpy integers): ``dataclasses.asdict`` of the JAX
    package's ``Scorer``.  The scorer is this system's whole parameter
    set; tests hand both packages the same one through this.  Raises on a
    missing, unknown or non-integral field."""
    names = [f.name for f in fields(Scorer)]
    if sorted(params) != sorted(names):
        raise ValueError(f"scorer fields must be {names}, got {sorted(params)}")
    values = {}
    for name in names:
        v = params[name]
        if int(v) != v:
            raise ValueError(f"scorer field {name} must be an integer, got {v!r}")
        values[name] = int(v)
    return Scorer(**values)


def worst_guide_diff_score(
    mismatch_net_cost: int = Defaults.MISMATCH_NET_COST,
    genome_gap_net_cost: int = Defaults.GENOME_GAP_NET_COST,
    guide_gap_net_cost: int = Defaults.GUIDE_GAP_NET_COST,
) -> int:
    """The worst net cost of introducing one difference in the guide region
    (SequentialGuideAligner.scala:213)."""
    return min(
        -abs(mismatch_net_cost), -abs(genome_gap_net_cost), -abs(guide_gap_net_cost)
    )
