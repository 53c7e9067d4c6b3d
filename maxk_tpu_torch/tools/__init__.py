"""Tools around training and benchmarking, each run as ``python -m
maxk_tpu_torch.tools.<name>``: the golden-accuracy recipe
(``golden_accuracy``), the warp4 metadata generator (``generate_meta``),
the suite tables of a benchmark record (``suite_report``) and the
re-audit of a record's rooflines (``reaudit_suite``)."""
