"""scene_build_s: host seconds of the port's scene build from the
benchmark's arrays (Scene.build, BVH leaf order, cluster pack, upload),
ending in a sync (the benchmark's own clock, the traced run's)."""


def read(rec):
    return rec["clock"]["scene_build_s"]
