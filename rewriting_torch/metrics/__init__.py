"""Samplers: clean samples (``sample``), the published edit requests
(``load_mask``) and samples of an edited model (``sample_edited``); the
metrics: FID (``inception``, ``fid``, ``get_fid``), the smile count
(``slimnet``, ``num_smiles``), LPIPS and the damage metric (``lpips``,
``distances``), the watermark erase, and the segmenters' registry
(``load_seg``)."""
