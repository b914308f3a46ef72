"""The benchmark's plain reference: plain PyTorch and NumPy, no kernels.

It imports nothing of the program under test.  ``config.py``,
``topology.py`` and ``potentials.py`` are frozen copies of the port's
modules of those names; ``g1.py`` and ``mitotic.py`` write the force fields
and the Brownian update out from the configuration and the chains, in any
dtype (float64 for the reference, bfloat16 for its control).  A CPU test
(``portbench/tests/test_portbench_reference.py``) holds the copies against
the port's plain versions, so that a drift on either side shows.
"""
