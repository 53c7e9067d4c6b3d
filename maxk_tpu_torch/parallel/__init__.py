"""Row-partitioned multi-device training on torch.distributed: process
groups (``mesh``), the halo exchange (``halo``), row sharding
(``partition``), the trainer (``dist_train``) and the CLI's launcher
(``launch``)."""
