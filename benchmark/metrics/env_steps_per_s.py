"""env_steps_per_s: every learner env-step of the window's whole
iterations over the window's seconds (host clock, synchronised at the
close)."""


def read(data):
    if "env_steps" not in data:
        return None
    return data["env_steps"] / data["window_s"]
