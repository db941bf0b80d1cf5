"""NBB baseline: correspondences on the device, MLS warp and Poisson blend
on the host."""
