"""Launchers: the input specs of every (architecture × shape cell), the
training launcher (``python -m repro_torch.launch.train``) and device meshes
over ``torch.distributed`` (``mesh``). The multi-pod dry-run is not ported
yet (ROADMAP.md queue 1: launch/dryrun)."""
