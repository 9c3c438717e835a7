"""Summary statistics over the reference's per-path summary frame.

The frame is a pandas DataFrame (engine/simulator.py builds it), but these
helpers only call its methods: this module imports no pandas, so the
payload assembly that uses them runs where pandas is not installed.
"""

from __future__ import annotations

from ..constants import SMALL_EPSILON


def success_mask(summary_df):
    """Per-path success flags, with the reference's documented fallback:
    when the Success column is absent, a path counts as successful iff its
    final balance exceeds epsilon (reference backend/simulation.py:1130-1136).
    The single definition shared by the facade, the payload assembly, the
    CLI report and the plots."""
    if "Success" in summary_df.columns:
        return summary_df["Success"].astype(bool)
    return summary_df["Final Balance"] > SMALL_EPSILON


def median_first_year_withdrawal_rate(summary_df) -> float:
    """Median per-path first-year real gross withdrawal / start balance (%).

    Withdrawals are deflated to retirement-date dollars (Trinity/Bengen basis).
    """
    if summary_df.empty:
        return float("nan")
    start = summary_df["Start Balance"]
    col = (
        "First Year Real Gross Withdrawal"
        if "First Year Real Gross Withdrawal" in summary_df.columns
        else "First Year Gross Withdrawal"
    )
    withdraw = summary_df[col]
    valid = start > SMALL_EPSILON
    if not valid.any():
        return float("nan")
    return float(((withdraw[valid] / start[valid]) * 100.0).median())
