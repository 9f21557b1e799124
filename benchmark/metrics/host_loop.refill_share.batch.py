"""Share of the window the host loop spent refilling slots: event detection and normalization of incoming reads and slot resets (program counter t_refill)."""



def read(rec):
    return rec["counters"]["t_refill"] / rec["window_s"]
