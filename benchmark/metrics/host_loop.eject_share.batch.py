"""Share of the reads the window harvested that overflowed a budget and
were ejected to a wider tier instead of yielded (program counter: the
mappers' ``ovf_why`` records); the tier runs once the input ends."""


def read(rec):
    c = rec["counters"]
    done = c["n_overflow"] + c["yielded"]
    return c["n_overflow"] / done if done else None
