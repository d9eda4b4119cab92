"""Entry sharding over GPUs (mesh.py) and over processes (distributed.py)."""
