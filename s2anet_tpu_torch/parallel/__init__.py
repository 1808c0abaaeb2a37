"""Data-parallel training: the process group (:mod:`.mesh`) and the
gradient sum of the train step (:mod:`.step`)."""
