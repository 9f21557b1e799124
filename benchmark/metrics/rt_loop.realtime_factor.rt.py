"""Simulated seconds the ReadUntil loop covered per wall second of the
window: the program's ``rt_ticks`` counter times the tick, over the
window's wall seconds.  1 keeps pace with the pore."""


def read(rec):
    n = rec.get("counts", {}).get("rt_ticks")
    return n * rec["tick_s"] / rec["window_s"] if n else None
