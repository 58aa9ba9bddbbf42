"""auction_rounds_per_step.train: the auction's rounds in the window
(the matcher's `solver_stats["auction_rounds"]`) over its train steps.
None where the matcher ran no auction."""


def read(r):
    c = r.counters
    if r.kind != "train" or not c.get("auction_calls") or not c["steps"]:
        return None
    return c["auction_rounds"] / c["steps"]
