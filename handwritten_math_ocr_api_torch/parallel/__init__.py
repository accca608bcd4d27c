"""The device mesh of the port: data-sharded serving and data x tensor
training (``mesh.py``)."""
