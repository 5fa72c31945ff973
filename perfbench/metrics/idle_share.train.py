"""The share of the traced steps in which no operation ran on the
device (1 − the union of its operations' intervals over the stretch),
in %."""


def read(obs):
    tr = obs.get("trace") or {}
    if not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
