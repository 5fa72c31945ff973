"""Milliseconds of a train step's optimizer phase (``mark("optimizer")``
to ``mark("end")``, CUDA events), mean over the window's steps the
profiler does not trace."""


def read(obs):
    steps = [s["optimizer"] for s in obs.get("phases", [])
             if "optimizer" in s]
    return sum(steps) / len(steps) if steps else None
