"""Small sizes of the cells for the CPU tests."""

SMALL = {"config": {"num_nodes": 1500, "approx_num_edges": 4500}}
