from occm_tpu_torch.attack.pgd import pgd_attack

__all__ = ["pgd_attack"]
