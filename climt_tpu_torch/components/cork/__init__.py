"""CORK longwave radiation (climt_tpu/components/cork/): correlated-k
tables and Parmentier & Guillot picket-fence optics.  Not exported from
the package root, as the JAX package exports it from neither root; the
component is ``climt_tpu_torch.components.cork.lw.CorkLongwaveRadiation``.
"""
