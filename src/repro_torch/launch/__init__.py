"""Launchers: the input specs of every (architecture × shape cell) and the
training launcher (``python -m repro_torch.launch.train``). The production
mesh and the multi-pod dry-run are not ported yet (ROADMAP.md queue 1:
sharding and the distributed stack)."""
