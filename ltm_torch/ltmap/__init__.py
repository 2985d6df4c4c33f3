from ltm_torch.ltmap.compose import compose_updated_maps  # noqa: F401
