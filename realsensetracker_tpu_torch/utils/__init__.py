"""Host-side utilities: device traces, layer spans, NaN checks."""
