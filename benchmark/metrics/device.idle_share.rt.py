"""Share of the profiled stretch of the ReadUntil loop's engine advances
in which no kernel, copy or memset ran on the card: 1 - (union of
device-busy intervals) / wall."""


def read(rec):
    p = rec.get("profile")
    if not p or not p["busy_s"] or not p["wall_s"]:
        return None
    return 1.0 - p["busy_s"] / p["wall_s"]
