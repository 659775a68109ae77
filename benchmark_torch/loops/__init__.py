"""The drivers of a window: ``<loop>.py`` holds ``run(entry, flatten, pool,
mix, seconds, seed, device, spans, **kw) -> common.traffic.Window``; a
traffic mix names its driver under ``loop``."""
