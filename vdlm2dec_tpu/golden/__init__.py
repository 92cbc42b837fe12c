"""Golden reference layer: pure-NumPy, sample-at-a-time oracle.

This subpackage pins the exact semantics of every stage of the VDL-M2 chain
(as implemented by the reference decoder) in slow, obvious Python.  It is
the test oracle for the device pipeline — never used in the hot path.
"""
from . import codec, dsp  # noqa: F401
