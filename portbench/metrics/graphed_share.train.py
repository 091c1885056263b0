"""How far the traced training steps ran from a CUDA graph (%): 100 R /
(R + F) inside the traced span, where R counts the program's
``ucnerf.graph_replay`` spans (one a replay of a step's microbatch loop)
and F its ``ucnerf.forward`` spans (one an eager microbatch's forward).
Replayed steps alone read 100, eager steps alone 0.  A trace that mixes
them reads replays over replays plus eager microbatches, not a share of
steps: one replayed and one eager step of M microbatches read
100 / (1 + M).  A trace with neither span reads nothing."""

REPLAY = "ucnerf.graph_replay"
FORWARD = "ucnerf.forward"


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    t = run.trace
    inside = [e["name"] for e in t.host
              if t.t0 <= float(e["ts"]) <= t.t1]
    r, f = inside.count(REPLAY), inside.count(FORWARD)
    if not r + f:
        return None
    return 100.0 * r / (r + f)
