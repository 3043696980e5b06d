from repro_torch.dataio.synthetic import synthetic_faces, synthetic_video  # noqa: F401
