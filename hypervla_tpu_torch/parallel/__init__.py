"""Multi-device training on torch.distributed: the mesh (mesh.py), the
sharded train state and the step's collectives (sharded.py), and runs of
ranks on the CPU (dryrun.py)."""
