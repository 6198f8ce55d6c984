"""Faults planted in the timed path, for the check of the check: each one
must turn ``correct`` false (``tests/test_bench_faults.py`` on the CPU,
``run.py --fault <name>`` at a cell's size on the card).  Each takes the
trainer before ``fit``.  The cells run on one chip, so the fault of an
exchange between chips has no place here."""


def unchanged_state(trainer):
    """The step returns the state it was given: no Adam step, no change."""
    def finish_step(state, g_gauss, g_extra, logs, *args, **kwargs):
        return state, logs

    trainer.system.finish_step = finish_step


def half_batch(trainer):
    """Half the views left out: the second half of the rendered views
    replaced by the first, so the loss means over the first half."""
    system = trainer.system
    render = system.render_batch

    def render_batch(*args, **kwargs):
        out = render(*args, **kwargs)
        for key in ("comp_rgb", "comp_depth", "comp_mask", "comp_normal"):
            if key in out:
                v = out[key]
                half = v.shape[0] // 2
                out[key] = v[:half].repeat((2,) + (1,) * (v.dim() - 1))
        return out

    system.render_batch = render_batch


def altered_answer(trainer):
    """The UNet's noise prediction 10% off where it is produced."""
    guidance = trainer.system.guidance
    denoiser = guidance.denoiser

    def altered(*args):
        return tuple(e * 1.1 for e in denoiser(*args))

    guidance.denoiser = altered


FAULTS = {f.__name__: f for f in (unchanged_state, half_batch, altered_answer)}
