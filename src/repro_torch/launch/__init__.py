"""Launch layer: device meshes (port of ``repro.launch``; its roofline,
dry-run, HLO cost and hill-climb modules are not ported yet)."""
