"""Share of the traced window (the cell's own route) in which no kernel or
copy ran on the device: the union of busy intervals."""


def read(t):
    return t["window"].idle_pct()
