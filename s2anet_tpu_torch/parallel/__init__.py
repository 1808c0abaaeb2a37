"""Work over several processes: the process group (:mod:`.mesh`), the
gradient sum of the data-parallel train step (:mod:`.step`), and spatial
serving, one image's rows sharded over the ranks (:mod:`.rows`,
:mod:`.spatial`)."""
