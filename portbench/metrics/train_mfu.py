"""Model FLOPs of the window's train steps (6 * params * tokens plus
attention) over the window times the bf16 peak."""

from portbench import peaks, work


def read(obs):
    if obs.kind != "train" or obs.steps <= 0:
        return None
    t = obs.traffic
    flops = obs.steps * work.train_step_flops(obs.cfg, obs.cfg.param_count(),
                                              int(t["batch"]), int(t["seq_len"]))
    return 100.0 * flops / (obs.window_s * peaks.BF16_FLOPS)
