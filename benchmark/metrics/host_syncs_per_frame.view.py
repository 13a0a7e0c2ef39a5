"""Blocking exchanges between host and device a frame: the program's
fov.sync.* spans (rank 0's, on several cards), one a sync on a card.
None where the program opens no fov.frame span."""


def read(rec):
    names = [r["name"] for r in rec["ranges"]]
    if "fov.frame" not in names:
        return None
    return sum(n.startswith("fov.sync.") for n in names) / rec["units"]
