"""Host milliseconds of ``ServeEngine.step`` (admit with its prefills,
then one batched decode, ending in the copy of the next tokens to the
host), mean over the window's ticks the profiler does not trace."""


def read(obs):
    ticks = obs.get("tick_s", [])
    return 1e3 * sum(ticks) / len(ticks) if ticks else None
