"""The decode profiling tools of the port, the counterparts of the JAX
package's tools/dec_profile.py, dec_anatomy.py, tape_probe.py and
probe_scalar.py (which stay the reference).  Each runs as
`python -m snappytpu_torch.tools.<name>`; with `--device cuda` it times the
hand kernels on the card, with `--device cpu` it runs their plain versions."""
