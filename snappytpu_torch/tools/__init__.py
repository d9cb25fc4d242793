"""The tools of the port, the counterparts of the JAX package's tools/:
dec_profile.py, dec_anatomy.py, tape_probe.py, probe_scalar.py (the decode
profiling tools), stage_profile.py, enc_profile.py, enc_stage_fast.py,
enc_ablate.py, enc_sizes.py, enc_variants.py (the encoder tools),
dist_bench.py, bigfile_bench.py (the bench series) and config4_mesh.py (the
mesh check of BASELINE config 4), which stay the reference.  Each runs as
`python -m snappytpu_torch.tools.<name>`; with `--device cuda` it runs the
hand kernels on the card, with `--device cpu` their plain versions."""
