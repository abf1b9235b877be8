from repro_torch.roofline.analysis import (CellReport, CostMode, model_flops,
                                           parse_collectives, roofline_terms)

__all__ = ["CellReport", "CostMode", "model_flops", "parse_collectives", "roofline_terms"]
