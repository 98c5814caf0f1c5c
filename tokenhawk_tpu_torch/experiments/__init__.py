"""The port's experiment scripts, each run as `python -m
tokenhawk_tpu_torch.experiments.<name>`; importing one runs nothing."""
