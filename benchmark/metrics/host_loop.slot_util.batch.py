"""Slot-events that carried a live read over slot-events dispatched (B * T a block), in the window, over every mapper of the chain (program counters useful_events, disp_events)."""



def read(rec):
    c = rec["counters"]
    return c["useful_events"] / c["disp_events"] if c["disp_events"] else None
