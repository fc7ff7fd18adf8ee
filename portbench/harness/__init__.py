"""The benchmark harness of the PyTorch/CUDA port (``stopthepop_tpu_torch``).

Everything a cell needs is found by name: its configuration in
``portbench/configs/<name>.json``, its traffic mix in
``portbench/traffic/<name>.json``, read by the driver that the mix's
``kind`` names (``portbench/drivers/<kind>.py``), its limits in
``portbench/limits/<cell>.json`` and each per-layer metric's reader in
``portbench/metrics/<metric>.py``. What depends on the configuration's
sort mode is found by the mode's name too: the reference's blend in
``portbench/reference/blend_<mode>.py`` (its backward in
``blend_<mode>_bwd.py``) and the blend's counts in
``harness/counts_<mode>.py``.
"""
