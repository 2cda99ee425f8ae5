"""az.mfu: the window's iterations times the FLOPs an iteration needs
(``benchmark/flops/<config>.py``, counted from the configuration's widths:
the search's evaluations and the updates) over the window's seconds and
the card's dense bf16 peak; a ratio."""


def read(data):
    if "flops_per_iter" not in data or not data.get("peak_flops"):
        return None
    return data["flops_per_iter"] * data["iterations"] / data["window_s"] / data["peak_flops"]
