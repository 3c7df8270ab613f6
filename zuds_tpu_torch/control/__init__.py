"""The port's control daemons (twins of ``control/``): ``controller``
hands the night's unprocessed pairs to ``nightly`` workers,
``makesources`` associates detections with sources and flags those that
trigger an alert, ``phot_controller`` runs the forced-photometry worker
and flags the detections whose alert is ready. Each runs as
``python -m zuds_tpu_torch.control.<name> [--once]``."""
