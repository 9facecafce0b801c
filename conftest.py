collect_ignore = ["_archive", "chiprun_out", "_train_ckpt"]
