"""Measurement tools of the port, run as
`python -m dinov2_od_tpu_torch.tools.<name>`."""
