"""The LW k-table tools of the port: ``calibrate_lw_ktables`` fits the
surrogate's parameters through the LW pipeline, ``build_lw_surrogate_ktables``
writes the npz from them.  Run as ``python -m climt_tpu_torch.tools.<name>``.
"""
