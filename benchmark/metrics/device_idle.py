"""The share of the traced stretch in which neither a kernel nor a copy
ran on the card, %; None without a trace."""


def read(run):
    tr = run.trace
    if not tr or tr.get("window_s", 0) <= 0:
        return None
    return (1 - tr["busy_s"] / tr["window_s"]) * 100
