"""Samples the train steps completed over those they claimed (W x H x
spp_step a step): the scan's claim gate drops the samples of a pixel whose
paths run long. The step's own counter (`stats["done"]`)."""


def read(run):
    if run.kind != "train" or not run.units:
        return None
    return sum(u["done"] for u in run.units) / sum(u["claimed"] for u in run.units)
