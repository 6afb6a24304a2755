"""estimators_roofline_pct: the four inbreeding estimators of an INBREED call
(kgt.inbreed.ritland, .simple, .hallme, .loglik), the bound of their work
(metrics/_inbreed.py) over the device time launched in their spans."""

from port_bench.metrics._inbreed import roofline_pct


def read(ctx):
    return roofline_pct(ctx)
