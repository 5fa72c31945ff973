"""Milliseconds of a train step's backward phase (``make_train_step``'s
``mark("backward")`` to the next mark, CUDA events), summed over the
step's microbatches, mean over the window's steps the profiler does not
trace."""


def read(obs):
    steps = [s["backward"] for s in obs.get("phases", []) if "backward" in s]
    return sum(steps) / len(steps) if steps else None
