"""The program's spans (tpustomp_torch.utils.tracing), which it records
while a torch.profiler records: what the `program_span` metrics read,
through lib.spans."""

from __future__ import annotations


def recorded() -> list | None:
    """The spans the program recorded, or None where it records none (a
    tree before its spans) or its buffer dropped any."""
    try:
        from tpustomp_torch.utils import tracing
        rec = tracing.recorded()
    except (ImportError, AttributeError):
        return None
    return None if rec.dropped else rec.spans
