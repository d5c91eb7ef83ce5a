"""Plain PyTorch fine-tuning steps of Mask R-CNN, the benchmark's
reference for the training cells.

One step, as the configuration states it (Detectron2's recipe with the
reference's solver): the augmentations (brightness, contrast, saturation
blends, a 90° rotation and a vertical flip with their probabilities, PCA
lighting), the RPN's anchor matching (IoU 0.7 / 0.3, every gt's best
anchors forced foreground) and its balanced sample, the ROI heads' sample
over proposals and gt boxes (IoU 0.5), the five losses (RPN BCE and L1,
box softmax CE and L1 on foreground, mask BCE on the target class), then
SGD: weight decay added to the gradient, clipping by its global norm,
momentum, and the learning rate of the warm-up schedule.

The random numbers come from a ``torch.Generator`` seeded per step, drawn
in the order the configuration's pipeline consumes them: the augmentation
draws of the batch, then the two samplers' uniforms.  ``proposals``, when
given, replace the reference's own proposal selection (the correctness
check follows the program's proposals; see ``judge.py``).

Everything runs in float32 with TF32 off, in blocks of images whose losses
share the batch's denominators, so their gradients add up to the batch's.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from benchmark.reference import maskrcnn as R

GRAY = (0.299, 0.587, 0.114)
EIGVEC = ((-0.5675, 0.7192, 0.4009), (-0.5808, -0.0045, -0.8140),
          (-0.5836, -0.6948, 0.4203))
EIGVAL = (0.2175, 0.0188, 0.0045)
LOSSES = ("rpn_cls", "rpn_loc", "cls", "box_reg", "mask")


def step_generator(seed: int, step: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((seed + 1) * 1_000_003 + step)
    return g


def augment_draws(n: int, inp: dict, gen, device) -> Dict[str, torch.Tensor]:
    u = lambda: torch.rand(n, generator=gen, device=device)
    span = lambda lo, hi: lo + (hi - lo) * u()
    d = {"brightness": span(*inp["brightness_range"]),
         "contrast": span(*inp["contrast_range"]),
         "saturation": span(*inp["saturation_range"])}
    d["do_rot"] = u() < inp["rotation_prob"]
    d["lighting"] = torch.randn(n, 3, generator=gen, device=device)
    d["do_flip"] = u() < inp["vflip_prob"]
    return d


def augment(img, boxes, masks, d, inp):
    """img [B,S,S,3] f32 0..255, boxes [B,N,4], masks [B,N,S,S] bool."""
    b, s = img.shape[:2]
    w = lambda k: d[k].reshape(b, 1, 1, 1)
    img = img * w("brightness")
    mean = img.mean(dim=(1, 2, 3), keepdim=True)
    img = (1 - w("contrast")) * mean + w("contrast") * img
    gray = (img * torch.tensor(GRAY, device=img.device)).sum(-1, keepdim=True)
    img = (1 - w("saturation")) * gray + w("saturation") * img
    rot = d["do_rot"]
    img = torch.where(rot.reshape(b, 1, 1, 1), img.rot90(1, (1, 2)), img)
    x1, y1, x2, y2 = boxes.unbind(-1)
    boxes = torch.where(rot.reshape(b, 1, 1),
                        torch.stack([y1, s - x2, y2, s - x1], -1), boxes)
    masks = torch.where(rot.reshape(b, 1, 1, 1), masks.rot90(1, (2, 3)), masks)
    vec = torch.tensor(EIGVEC, device=img.device)
    val = torch.tensor(EIGVAL, device=img.device)
    img = img + ((d["lighting"] * inp["lighting_scale"] * val) @ vec.T)[
        :, None, None, :]
    flip = d["do_flip"]
    img = torch.where(flip.reshape(b, 1, 1, 1), img.flip(1), img)
    x1, y1, x2, y2 = boxes.unbind(-1)
    boxes = torch.where(flip.reshape(b, 1, 1),
                        torch.stack([x1, s - y2, x2, s - y1], -1), boxes)
    masks = torch.where(flip.reshape(b, 1, 1, 1), masks.flip(2), masks)
    return img.clamp(0, 255), boxes, masks


def match(iou, gt_valid, fg, bg, low_quality):
    """iou [B,A,G] → (matched gt index [B,A], label 1 / 0 / -1 [B,A])."""
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    best, idx = iou.max(dim=-1)
    # torch.max on a dim returns an index of the max, not promised the
    # first: take the first explicitly
    idx = (iou == best[..., None]).to(torch.uint8).argmax(-1)
    lab = torch.where(best >= fg, 1, torch.where(best < bg, 0, -1))
    if low_quality:
        per_gt = iou.amax(dim=-2)
        is_best = (iou == per_gt[:, None, :]) & gt_valid[:, None, :] & \
            (per_gt[:, None, :] > 0)
        force = is_best.any(-1)
        lab = torch.where(force, 1, lab)
        idx = torch.where(force & (best < fg),
                          is_best.to(torch.uint8).argmax(-1), idx)
    lab = torch.where(best < 0, 0, lab)
    return idx, lab


def subsample(labels, num, frac, u_pos, u_neg):
    """Exactly ``num`` picks: up to num·frac foregrounds by the highest
    ``u_pos``, then backgrounds by the highest ``u_neg``; the slots beyond
    what exists repeat the first pick and count as background.  → (index
    [B,num], positive [B,num])."""
    n = labels.shape[-1]
    ninf = torch.full_like(u_pos, -math.inf)
    pos = R.sort_desc(torch.where(labels == 1, u_pos, ninf))
    k_pos = min(int(num * frac), n)
    pv, pi = pos.values[:, :k_pos], pos.indices[:, :k_pos]
    p_take = pv > -math.inf
    n_pos = p_take.sum(-1, keepdim=True)
    neg = R.sort_desc(torch.where(labels == 0, u_neg, ninf))
    k_neg = min(num, n)
    nv, ni = neg.values[:, :k_neg], neg.indices[:, :k_neg]
    n_take = (nv > -math.inf) & (torch.arange(k_neg, device=labels.device)
                                 < num - n_pos)
    idx = torch.cat([pi, ni], -1)
    take = torch.cat([p_take, n_take], -1)
    is_pos = torch.cat([p_take, torch.zeros_like(n_take)], -1)
    # taken picks first, in order
    order = torch.sort((~take).to(torch.uint8), dim=-1,
                       stable=True).indices[:, :num]
    idx, take, is_pos = (torch.gather(t, -1, order) for t in (idx, take, is_pos))
    return torch.where(take, idx, idx[:, :1]), is_pos & take


def crop_resize(masks, boxes, size):
    """masks [N,H,W] bool, boxes [N,4] → [N,size,size] bilinear samples at
    the bin centres (RoIAlign aligned on the bitmask)."""
    n, h, w = masks.shape
    t = (torch.arange(size, dtype=torch.float32, device=boxes.device) + 0.5) / size
    x1, y1, x2, y2 = boxes.unbind(-1)
    xs = (x1[:, None] + t * (x2 - x1).clamp_min(1e-6)[:, None] - 0.5).clamp(0, w - 1)
    ys = (y1[:, None] + t * (y2 - y1).clamp_min(1e-6)[:, None] - 0.5).clamp(0, h - 1)
    xl, yl = xs.floor().long(), ys.floor().long()
    xh, yh = (xl + 1).clamp_max(w - 1), (yl + 1).clamp_max(h - 1)
    fx, fy = (xs - xl)[:, None, :], (ys - yl)[:, :, None]
    i = torch.arange(n, device=boxes.device)[:, None, None]
    at = lambda yy, xx: masks[i, yy[:, :, None], xx[:, None, :]].float()
    top = at(yl, xl) * (1 - fx) + at(yl, xh) * fx
    bot = at(yh, xl) * (1 - fx) + at(yh, xh) * fx
    return top * (1 - fy) + bot * fy


def sigmoid_ce(x, z):
    return x.clamp_min(0) - x * z + torch.log1p(torch.exp(-x.abs()))


def lr_at(solver: dict, step: int) -> float:
    """Warm-up from warmup_factor·base_lr to base_lr over warmup_iters
    (counted in float32), then ×gamma at each milestone."""
    f = lambda v: torch.tensor(v, dtype=torch.float32)
    t = torch.clamp(f(step) / f(max(solver["warmup_iters"], 1)), max=1.0)
    lr = f(solver["base_lr"]) * (f(solver["warmup_factor"]) * (1 - t) + t)
    n = sum(step >= s for s in solver.get("steps", ()))
    return float(lr * f(solver["gamma"]) ** n)


def trainable(path: str, freeze_at: int) -> bool:
    if "frozen_bn" in path:
        return False
    if freeze_at >= 1 and "/stem_" in "/" + path:
        return False
    return not any(freeze_at >= s and f"res{s}_block" in path
                   for s in (2, 3, 4, 5))


class Trainer:
    """The reference's training steps from ``weights`` (flat Flax-layout
    f32 tensors), the masters and momentum kept in f32."""

    def __init__(self, weights, cfg: dict, quant: Optional[str] = None,
                 block: int = 4):
        self.cfg = cfg
        m = cfg["model"]
        self.solver = cfg["solver"]
        self.params = {k: v.detach().clone().float() for k, v in weights.items()}
        self.train_keys = [k for k in self.params
                           if trainable(k, self.solver["freeze_at"])]
        for k in self.train_keys:
            self.params[k].requires_grad_(True)
        self.traces = {k: torch.zeros_like(self.params[k])
                       for k in self.train_keys}
        self.net = R.Net(self.params, m["depth"], m["num_classes"], quant)
        self.block = block
        self.step = 0

    def _rois_and_targets(self, props, p_valid, boxes, valid, classes, d):
        """The ROI heads' sample from proposals and gt."""
        mc = self.cfg["model"]
        cand = torch.cat([props, boxes], 1)
        cvalid = torch.cat([p_valid, valid], 1)
        gi, lab = match(R.iou(cand, boxes), valid, mc["roi_fg_iou_thresh"],
                        mc["roi_fg_iou_thresh"], False)
        lab = torch.where(cvalid, lab, -1)
        sidx, spos = subsample(lab, mc["roi_batch_size_per_image"],
                               mc["roi_positive_fraction"], d["roi_pos"],
                               d["roi_neg"])
        rois = torch.gather(cand, 1, sidx[..., None].expand(-1, -1, 4))
        rgt = torch.gather(gi, 1, sidx)
        return rois, rgt, spos

    def _inputs(self, batch, seed: int):
        """The step's generator, augmentation draws, augmented batch,
        anchors and level sizes."""
        mc, inp = self.cfg["model"], self.cfg["input"]
        dev = batch["image"].device
        b, s = batch["image"].shape[:2]
        gen = step_generator(seed, self.step, dev)
        d = augment_draws(b, inp, gen, dev)
        img, boxes, masks = augment(batch["image"].float(),
                                    batch["boxes"].float(), batch["masks"],
                                    d, inp)
        anc = R.anchors((s, s), mc["anchor_sizes"], mc["anchor_aspect_ratios"],
                        dev)
        lv_n = R.level_sizes((s, s), len(mc["anchor_aspect_ratios"]))
        return gen, d, img, boxes, masks, anc, lv_n

    @torch.no_grad()
    def _own(self, img, anc, lv_n):
        """The reference's own proposals (``maskrcnn.proposals``' dict)."""
        mc = self.cfg["model"]
        s = img.shape[1]
        out = []
        for i in range(0, img.shape[0], self.block):
            f = self.net.features(img[i:i + self.block], mc["pixel_mean"])
            o, dl = self.net.rpn(f)
            out.append(R.proposals(
                o, dl, anc, (s, s), lv_n, mc["rpn_pre_nms_topk_train"],
                mc["rpn_post_nms_topk_train"], mc["rpn_nms_thresh"]))
        return {k: out[0][k] if k == "cand_level" else
                torch.cat([o[k] for o in out]) for k in out[0]}

    def own_proposals(self, batch, seed: int):
        """The reference's own proposals for the next step's batch,
        without taking the step."""
        _, _, img, _, _, anc, lv_n = self._inputs(batch, seed)
        return self._own(img, anc, lv_n)

    def run_step(self, batch, seed: int, proposals=None):
        """One step on {image [B,S,S,3] uint8, boxes, classes, valid,
        masks [B,N,S,S] bool}; ``proposals`` {"boxes", "logits", "valid"}
        replace the reference's own.  → (losses {name: float}, the
        proposals used)."""
        mc = self.cfg["model"]
        gen, d, img, boxes, masks, anc, lv_n = self._inputs(batch, seed)
        dev = img.device
        b = img.shape[0]
        valid = batch["valid"]
        classes = batch["classes"].long()
        if proposals is None:
            proposals = self._own(img, anc, lv_n)
        props, pvalid = proposals["boxes"], proposals["valid"]
        n_cand = props.shape[1] + boxes.shape[1]
        d.update(zip(("rpn_pos", "rpn_neg"), (
            torch.rand(b, anc.shape[0], generator=gen, device=dev),
            torch.rand(b, anc.shape[0], generator=gen, device=dev))))
        d.update(zip(("roi_pos", "roi_neg"), (
            torch.rand(b, n_cand, generator=gen, device=dev),
            torch.rand(b, n_cand, generator=gen, device=dev))))
        with torch.no_grad():
            rois, rgt, spos = self._rois_and_targets(props, pvalid, boxes,
                                                     valid, classes, d)
            fg_total = float(spos.sum())
        r = rois.shape[1]
        n_all = b * r
        totals = dict.fromkeys(LOSSES, 0.0)
        for i in range(0, b, self.block):
            j = slice(i, i + self.block)
            parts = self._block_losses(
                img[j], boxes[j], classes[j], masks[j], valid[j], anc,
                {k: v[j] for k, v in d.items()}, rois[j], rgt[j], spos[j],
                b, n_all, fg_total)
            sum(parts.values()).backward()
            for k, v in parts.items():
                totals[k] += float(v.detach())
        self._apply()
        return totals, proposals

    def _block_losses(self, img, boxes, classes, masks, valid, anc, d, rois,
                      rgt, spos, b_all, n_all, fg_total):
        mc = self.cfg["model"]
        net = self.net
        bb = img.shape[0]
        feats = net.features(img, mc["pixel_mean"])
        obj, dl = net.rpn(feats)
        gi, lab = match(R.iou(anc, boxes), valid, mc["rpn_fg_iou_thresh"],
                        mc["rpn_bg_iou_thresh"], True)
        idx, pos = subsample(lab, mc["rpn_batch_size_per_image"],
                             mc["rpn_positive_fraction"], d["rpn_pos"],
                             d["rpn_neg"])
        lbl = pos.float()
        rpn_cls = sigmoid_ce(torch.gather(obj, 1, idx), lbl).mean(1)
        tgt_boxes = torch.gather(boxes, 1, torch.gather(gi, 1, idx)[
            ..., None].expand(-1, -1, 4))
        tgt = R.encode(anc[idx], tgt_boxes, (1.0, 1.0, 1.0, 1.0))
        pd = torch.gather(dl, 1, idx[..., None].expand(-1, -1, 4))
        rpn_loc = ((pd - tgt).abs().sum(-1) * lbl).sum(1) / \
            mc["rpn_batch_size_per_image"]

        k = mc["num_classes"]
        r = rois.shape[1]
        n = bb * r
        cls_t = torch.where(spos, torch.gather(classes, 1, rgt),
                            torch.full_like(rgt, k)).reshape(n)
        reg_t = R.encode(rois, torch.gather(boxes, 1, rgt[..., None].expand(
            -1, -1, 4)), tuple(mc["roi_bbox_reg_weights"])).reshape(n, 4)
        fg = spos.reshape(n).float()
        pooled = R.pool(feats, rois, mc["pooler_resolution_box"],
                        mc["pooler_window"])
        logits, deltas = net.box_head(pooled.reshape((n,) + pooled.shape[2:]))
        ce = -torch.gather(torch.log_softmax(logits, -1), 1, cls_t[:, None])[:, 0]
        fg_cls = cls_t.clamp(0, k - 1)
        per = deltas[torch.arange(n, device=img.device), fg_cls]
        out = {"rpn_cls": rpn_cls.sum() / b_all,
               "rpn_loc": rpn_loc.sum() / b_all,
               "cls": ce.sum() / n_all,
               "box_reg": ((per - reg_t).abs().sum(-1) * fg).sum() / n_all}
        res = mc["mask_head_resolution"]
        flat_masks = masks.reshape((-1,) + masks.shape[2:])
        which = (torch.arange(bb, device=img.device)[:, None] * masks.shape[1]
                 + rgt).reshape(n)
        gt_roi = crop_resize(flat_masks[which], rois.reshape(n, 4), res)
        mp = R.pool(feats, rois, mc["pooler_resolution_mask"],
                    mc["pooler_window"])
        ml = net.mask_head(mp.reshape((n,) + mp.shape[2:]))
        sel = torch.gather(ml, 3, fg_cls[:, None, None, None].expand(
            -1, res, res, 1))[..., 0]
        mce = sigmoid_ce(sel, (gt_roi > 0.5).float()).mean(dim=(1, 2))
        out["mask"] = (mce * fg).sum() / max(fg_total, 1.0)
        return out

    @torch.no_grad()
    def _apply(self):
        sv = self.solver
        grads = {}
        for k in self.train_keys:
            p = self.params[k]
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads[k] = g + sv["weight_decay"] * p
            p.grad = None
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        if sv["clip_grad_norm"] > 0 and float(norm) >= sv["clip_grad_norm"]:
            scale = sv["clip_grad_norm"] / float(norm)
            grads = {k: g * scale for k, g in grads.items()}
        lr = lr_at(sv, self.step)
        for k in self.train_keys:
            self.traces[k].mul_(sv["momentum"]).add_(grads[k])
            self.params[k].sub_(lr * self.traces[k])
        self.step += 1
