"""play.policy_ms_p50: the median host ms of the zoo policy alone at B=1
(the call and its action as a host integer, the board already on the
device), over the traffic's first positions."""

import statistics


def read(data):
    ms = data.get("policy_ms")
    return statistics.median(ms) if ms else None
