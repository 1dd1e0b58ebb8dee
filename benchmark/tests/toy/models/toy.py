"""A toy image-translation GAN, a model added by files alone in the
benchmark's own tests: 32x32 RGB pairs; a generator conv -> BatchNorm ->
ReLU -> conv -> tanh, whose BatchNorm holds running statistics (buffers);
a patch discriminator on concat([target, source]); Adam with each
network's own learning rate and betas, as the two-time-scale update rule
(TTUR) of SPADE sets them. Its program is entries/toy_step.py, plain
torch; the reference here is functional and takes nothing of it."""

import torch
import torch.nn.functional as F

from benchmark.reference.precision import Precision

SIDE = 32
RANGES = ()  # the toy's program opens no ranges
BUFFERS = ("bn.running_mean", "bn.running_var", "bn.num_batches_tracked")


def make_splits(config, traffic, seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    train = tuple(torch.rand((traffic["train_pairs"], 3, SIDE, SIDE), generator=gen,
                             device=device) * 2 - 1 for _ in range(2))
    return {"train": train, "test": None}


def parameter_shapes(config):
    c, normal = config["network"]["channels"], ("normal", config["network"]["init_std"])
    return {
        "generator": [("conv1.weight", (c, 3, 3, 3), normal), ("bn.weight", (c,), 1.0),
                      ("bn.bias", (c,), 0.0), ("bn.running_mean", (c,), 0.0),
                      ("bn.running_var", (c,), 1.0), ("bn.num_batches_tracked", (), 0, "int64"),
                      ("conv2.weight", (3, c, 3, 3), normal), ("conv2.bias", (3,), 0.0)],
        "discriminator": [("conv.weight", (c, 6, 4, 4), normal),
                          ("head.weight", (1, c, 3, 3), normal), ("head.bias", (1,), 0.0)],
    }


def flops_per_image(config):
    """Conv MACs x 2: G's forward and its two backward passes; D's three
    forwards (fake for G's loss, real and fake for its own), the input
    gradient of the first and the weight gradients of the other two."""
    c = config["network"]["channels"]
    g = 2.0 * SIDE * SIDE * (c * 3 * 9 + 3 * c * 9)
    d = 2.0 * (SIDE // 2) ** 2 * (c * 6 * 16 + c * 9)
    return 3 * g + 3 * d + 3 * d


def _generator(net, p, x):
    y = F.conv2d(x, p["conv1.weight"], padding=1)
    y = F.batch_norm(y, p["bn.running_mean"], p["bn.running_var"], p["bn.weight"], p["bn.bias"],
                     True, net["batch_norm_momentum"], net["batch_norm_eps"])
    return torch.tanh(F.conv2d(F.relu(y), p["conv2.weight"], p["conv2.bias"], padding=1))


def _discriminator(net, p, target, source):
    x = F.conv2d(torch.cat([target, source], dim=1), p["conv.weight"], stride=2, padding=1)
    x = F.leaky_relu(x, net["leaky_relu_slope"])
    return F.conv2d(x, p["head.weight"], p["head.bias"], padding=1)


def _bce(logits, label):
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, label))


def reference_train(config, traffic, weights, pairs, seeds, steps, precision):
    net, s = config["network"], config["settings"]
    batch, n = traffic["batch_size"], pairs[0].shape[0]
    params = {k: {name: w.detach().clone() for name, w in ws.items()} for k, ws in weights.items()}
    trained = {k: [name for name in ws if name not in BUFFERS] for k, ws in params.items()}
    adam = {"generator": (s["g_learning_rate"], *s["g_betas"]),
            "discriminator": (s["d_learning_rate"], *s["d_betas"])}
    moments = {k: {name: (torch.zeros_like(params[k][name]), torch.zeros_like(params[k][name]))
                   for name in names} for k, names in trained.items()}
    out = {"losses": []}
    with Precision(precision).scope():
        for step in range(steps):
            rows = (step * batch + torch.arange(batch, device=pairs[0].device)) % n
            source, target = pairs[0][rows], pairs[1][rows]
            for k, names in trained.items():
                for name in names:
                    params[k][name].requires_grad_(True)
            g, d = params["generator"], params["discriminator"]
            fake = _generator(net, g, source)
            g_total = (_bce(_discriminator(net, d, fake, source), 1.0)
                       + s["lambda_l1"] * torch.mean(torch.abs(target - fake)))
            d_total = (_bce(_discriminator(net, d, target, source), 1.0)
                       + _bce(_discriminator(net, d, fake.detach(), source), 0.0))
            totals = {"generator": g_total, "discriminator": d_total}
            grads = {k: dict(zip(names, torch.autograd.grad(totals[k], [params[k][m] for m in names])))
                     for k, names in trained.items()}
            out["losses"].append([float(g_total), float(d_total)])
            if step == 0:
                out["grad_norms"] = {k: {name: float(t.double().norm()) for name, t in gs.items()}
                                     for k, gs in grads.items()}
            with torch.no_grad():
                for k, gs in grads.items():
                    lr, b1, b2 = adam[k]
                    for name, grad in gs.items():
                        p, (m, v) = params[k][name], moments[k][name]
                        m.mul_(b1).add_(grad, alpha=1.0 - b1)
                        v.mul_(b2).addcmul_(grad, grad, value=1.0 - b2)
                        denom = v.sqrt() / (1.0 - b2 ** (step + 1)) ** 0.5 + s["adam_eps"]
                        p.requires_grad_(False)
                        p.sub_(lr / (1.0 - b1 ** (step + 1)) * m / denom)
    out["change_norms"] = {k: {name: float((params[k][name] - weights[k][name]).double().norm())
                               for name in names} for k, names in trained.items()}
    return out


def port_config(cell, seeds):
    return {"network": cell.config["network"], "settings": cell.config["settings"],
            "batch_size": cell.traffic["batch_size"]}


@torch.no_grad()
def load_state(state, weights, seeds):
    state.generator.load_state_dict(weights["generator"], strict=True)
    state.discriminator.load_state_dict(weights["discriminator"], strict=True)


def _adam_first_gradient(beta1):
    return lambda param_state: param_state["exp_avg"] / (1.0 - beta1)


def networks(state, config):
    s = config["settings"]
    return (("generator", state.generator, state.g_optimizer,
             _adam_first_gradient(s["g_betas"][0])),
            ("discriminator", state.discriminator, state.d_optimizer,
             _adam_first_gradient(s["d_betas"][0])))


def losses_of(metrics):
    return [list(pair) for pair in zip(metrics["g_loss"].float().cpu().tolist(),
                                       metrics["d_loss"].float().cpu().tolist())]


def plant_half_batch():
    from benchmark.entries import toy_step

    original = toy_step.train_step

    def halved(state, source, target):
        half = source.shape[0] // 2
        return original(state, source[:half], target[:half])

    toy_step.train_step = halved
