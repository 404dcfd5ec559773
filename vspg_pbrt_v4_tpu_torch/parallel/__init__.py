"""Rendering on several devices over ``torch.distributed`` (counterpart of
the JAX package's ``parallel/``): ``mesh.py`` holds the sharded entry
points, ``dryrun.py`` runs them in a world of processes."""
