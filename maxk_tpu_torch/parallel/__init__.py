"""Row-partitioned and tensor-parallel multi-device training on
torch.distributed: process groups and the (graph x model) grid
(``mesh``), the halo exchange (``halo``), row sharding (``partition``),
column-parallel Dense layers (``tensor``), the trainer (``dist_train``)
and the CLI's launcher (``launch``)."""
