"""parallel layer of the PyTorch port: data groups, data-parallel training
and time-sharded inference (see the package docstring)."""
