"""hpl.panel_launches: the device activities launched a panel in the
profiled stretch: those whose runtime call starts inside an
``hpl.panel`` span (``launches_total``), over the panels.  On the card
the panel kernel, the swap kernel and a memset; a panel factored by the
host's launches shows here as thousands."""
from lcsc_bench.lib.spans import of


def read(rec):
    p = of(rec, "hpl.panel")
    return None if p is None else p["launches_total"] / p["count"]
