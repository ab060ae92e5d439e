"""ANSI console reporting (reference utils/train_utils.py:10-16, 102-198):
a copy of ``neural_marionette_tpu/utils/console.py``."""
from __future__ import annotations


class COLORS:
    HEADER = "\033[95m"
    OKBLUE = "\033[94m"
    OKGREEN = "\033[92m"
    WARNING = "\033[93m"
    FAIL = "\033[91m"
    ENDC = "\033[0m"
    BOLD = "\033[1m"
    UNDERLINE = "\033[4m"


_MODE_COLOR = {"train": COLORS.OKGREEN, "valid": COLORS.OKBLUE,
               "eval": COLORS.WARNING}


def display_opts(cfg) -> None:
    keys = ["training_id", "exp_name", "resume_epoch", "dataset", "nbatch",
            "grid_size", "Ttot", "Tcond", "nkeypoints", "dyna_module",
            "lrate", "recon_weight", "sparse_weight", "sep_weight",
            "vol_reg_weight", "local_const_weight", "time_const_weight",
            "sparsity_const_weight", "graph_traj_weight", "kypt_recon_weight",
            "kl_kypt_weight"]
    print("PARAMETERS:")
    for k in keys:
        print(f"    {k:22s} {COLORS.OKBLUE}{getattr(cfg, k)}{COLORS.ENDC}")


def display_it(mode: str, name: str, cfg, epoch_id: int, batch_id: int,
               value, print_every: int = 200) -> None:
    if batch_id % print_every != 0:
        return
    color = _MODE_COLOR.get(mode, COLORS.ENDC)
    print(f"[{color}{cfg.exp_name} - {name}{COLORS.ENDC}] "
          f"- {epoch_id}/{cfg.nepoch} - {batch_id:04d}   "
          f"{COLORS.BOLD}{float(value):f}{COLORS.ENDC}")


def display_phase(sched) -> None:
    print("\nMODULE ACTIVES:")
    for name, active in sched.module_actives.items():
        color = COLORS.OKBLUE if active else COLORS.FAIL
        print(f"    {name:10s} {color}{active}{COLORS.ENDC}")
    print("LOSSES OPTIMIZED:")
    for name in sched.current_loss_names:
        print(f"    {COLORS.WARNING}{name}{COLORS.ENDC}")
    print(f"    affinity_active={sched.affinity_active}\n")
