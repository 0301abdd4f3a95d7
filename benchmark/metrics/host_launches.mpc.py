"""Runtime launch and copy calls the host made in the traced episode, per
tick: engine.graph through the tick."""


def read(t):
    n = t["counts"].get("ticks")
    return t["window"].launches() / n if n else None
