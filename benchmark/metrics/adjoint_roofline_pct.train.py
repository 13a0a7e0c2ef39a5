"""Percent of their roofline that the material and envmap adjoint kernels
reach: the least time of a step's adjoints' bytes at the HBM rate
(harness/arith.train_adjoints_s) over their device time a step."""

import re

ADJOINT = re.compile(r"\b(material|envmap)_adjoint_kernel")


def read(rec):
    t = sum(k["dur"] for k in rec["kernels"]
            if ADJOINT.search(k["name"])) * 1e-6
    bound = rec["bounds"].get("adjoint_s")
    if not t or not bound:
        return None
    return 100.0 * bound / (t / rec["units"])
