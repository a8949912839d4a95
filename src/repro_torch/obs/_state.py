"""The one process-global telemetry switch.

A plain module attribute so the warm-path check (`if not _state.enabled`)
is a single dict lookup — both `metrics` and `trace` read it on every
increment/span. Kept in its own module to avoid an import cycle between
the two halves of the package.
"""

enabled = True
