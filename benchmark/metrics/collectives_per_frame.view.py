"""torch.distributed calls a frame on rank 0: the program's fov.coll.*
spans (dist/collectives.py), those of gather_frame included. None where
the program opens no fov.frame span."""


def read(rec):
    names = [r["name"] for r in rec["ranges"]]
    if "fov.frame" not in names:
        return None
    return sum(n.startswith("fov.coll.") for n in names) / rec["units"]
