"""fws_roofline_pct: a PfEMP statistics call's bound (metrics/_fws.py) over
the device time launched in kgt.fws.variants and kgt.fws.genomes."""

from port_bench.metrics._fws import roofline_pct


def read(ctx):
    return roofline_pct(ctx)
