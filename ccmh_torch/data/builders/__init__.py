"""Offline dataset builders, the port's own copies of ``ccmh``'s (numpy and
scipy only, run on the host):

* ``make_coco``, ``make_nuswide``, ``make_mirflickr25k`` — a raw dataset ->
  the ``index.mat`` / ``caption.mat`` / ``label.mat`` files the Trainer
  reads (``python -m ccmh_torch.data.builders.<name> --help``);
* ``twdh_centers`` — TwDH's class centres and pair-space transforms for any
  class count, read through ``--set twdh.center_path=<out.npz>``.
"""
