"""Share of the traced window in which the device idled while the host
was inside ``rst.tsdf.render`` (mapping.tsdf's render_model_depth, one
per camera a tick), split from the idle stretches by exact overlap
(spans.py). One reader for every cell group (``idle_in_render_pct.<group>``)."""

from h100bench import spans


def read(run):
    return spans.idle_in_pct(run, spans.RENDER)
