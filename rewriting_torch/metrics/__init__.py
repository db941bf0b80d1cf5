"""Samplers: clean samples (``sample``), the published edit
requests (``load_mask``) and samples of an edited model
(``sample_edited``)."""
