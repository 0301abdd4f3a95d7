"""Runtime launch and copy calls (kernels, graphs, memcpy, memset) the host
made in the traced window, per plan call: api.plan + engine.graph."""


def read(t):
    calls = t["counts"].get("calls")
    return t["window"].launches() / calls if calls else None
