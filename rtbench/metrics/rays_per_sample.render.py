"""Rays a sample of the window's frames: the renderer's exact ray count
(`stats["rays"]`, the program's counter) over the frames' pixel samples."""


def read(run):
    if run.kind != "frames" or not run.units:
        return None
    return sum(u["rays"] for u in run.units) / sum(u["samples"] for u in run.units)
