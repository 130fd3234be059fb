"""Config-driven training and testing CLI (port of ``vsr_tpu/main.py``).

Usage: ``python -m vsr_tpu_torch.main <config.yaml> [--test] [--device
cuda]``, with the JAX package's YAML section schema (``main / dataset /
dataloader / net / losses / metrics / optimizer / [lr_scheduler] / logger /
monitor / trainer``, and ``predictor`` for ``--test``) resolved through the
port's registries. Any ``*Loss`` name the port does not define itself
resolves to ``torch.nn`` (``losses.py``).

The net trains on ``trainer.kwargs.device`` of the config and is tested on
``predictor.kwargs.device`` (default ``cuda`` for both); ``--device``
overrides it. ``--test`` loads ``main.loaded_path``, a checkpoint that the
port's trainer or ``vsr_tpu``'s wrote (a flax msgpack file), and writes
``results.csv``, PNGs and GIFs under ``predictor.kwargs.saved_dir``.
``main.distributed`` is not ported yet and raises.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from vsr_tpu_torch.config import Config, load_config, save_config
from vsr_tpu_torch.registry import build, get_class
from vsr_tpu_torch.utils.recovery import find_latest_checkpoint
from vsr_tpu_torch.utils.rng import RngTree


def build_net(config, device: str):
    """Build the net on ``device``, its weights drawn from the config's seed
    (a YAML ``dtype`` string such as ``bfloat16`` is taken by the net)."""
    seed = config.main.get("random_seed", "vsr")
    return build("net", config.net, device=device,
                 generator=RngTree(seed).torch_generator("init"))


def build_losses(config):
    loss_fns, loss_weights = [], []
    for spec in config.losses:
        loss_fns.append(build("loss", spec))
        loss_weights.append(spec.get("weight", 1.0))
    return loss_fns, loss_weights


def build_metrics(config):
    return [build("metric", spec) for spec in config.metrics]


def run_train(config: Config, device: str | None = None):
    """Train as the config says; returns the trainer. ``device`` overrides
    ``trainer.kwargs.device`` (whose default is ``cuda``)."""
    if config.main.get("distributed"):
        raise NotImplementedError(
            "main.distributed (multi-host training) is not yet ported to "
            "vsr_tpu_torch")
    saved_dir = Path(config.main.saved_dir)
    saved_dir.mkdir(parents=True, exist_ok=True)
    save_config(config, saved_dir / "config.yaml")

    trainer_kwargs = dict(config.trainer.get("kwargs") or {})
    device = device or trainer_kwargs.pop("device", None) or "cuda"
    trainer_kwargs["device"] = device

    logging.info("Create the training and validation datasets.")
    train_dataset = build("dataset", config.dataset, type="train")
    valid_dataset = build("dataset", config.dataset, type="valid")

    logging.info("Create the training and validation dataloaders.")
    dl_kwargs = dict(config.dataloader.get("kwargs") or {})
    train_bs = dl_kwargs.pop("train_batch_size")
    valid_bs = dl_kwargs.pop("valid_batch_size")
    # Dataset classes may define a custom collate_fn.
    collate_fn = getattr(get_class("dataset", config.dataset.name), "collate_fn", None)
    if collate_fn is not None:
        dl_kwargs.setdefault("collate_fn", collate_fn)
    train_loader = build(
        "loader", {"name": config.dataloader.name, "kwargs": dl_kwargs},
        train_dataset, batch_size=train_bs,
    )
    valid_kwargs = {**dl_kwargs, "shuffle": False}
    valid_loader = build(
        "loader", {"name": config.dataloader.name, "kwargs": valid_kwargs},
        valid_dataset, batch_size=valid_bs,
    )

    logging.info("Create the network architecture.")
    net = build_net(config, device)

    logging.info("Create the loss functions and the metric functions.")
    loss_fns, loss_weights = build_losses(config)
    metric_fns = build_metrics(config)

    logging.info("Create the optimizer.")
    optimizer = build("optimizer", config.optimizer)

    lr_scheduler = None
    if config.get("lr_scheduler"):
        logging.info("Create the learning rate scheduler.")
        lr_scheduler = build("lr_scheduler", config.lr_scheduler)

    logging.info("Create the logger.")
    logger = build("logger", config.logger, log_dir=saved_dir / "log")

    logging.info("Create the monitor.")
    monitor = build("monitor", config.monitor, checkpoints_dir=saved_dir / "checkpoints")

    logging.info("Create the trainer.")
    trainer = build(
        "trainer",
        {"name": config.trainer.name, "kwargs": trainer_kwargs},
        train_dataloader=train_loader,
        valid_dataloader=valid_loader,
        net=net,
        loss_fns=loss_fns,
        loss_weights=loss_weights,
        metric_fns=metric_fns,
        optimizer=optimizer,
        lr_scheduler=lr_scheduler,
        logger=logger,
        monitor=monitor,
        random_seed=config.main.get("random_seed", "vsr"),
    )

    loaded_path = config.main.get("loaded_path")
    if not loaded_path and config.main.get("auto_resume"):
        found = find_latest_checkpoint(saved_dir / "checkpoints")
        if found:
            loaded_path = str(found)
            logging.info(f'Auto-resume found checkpoint "{loaded_path}".')
    if loaded_path:
        logging.info(f'Load the previous checkpoint from "{loaded_path}".')
        trainer.load(Path(loaded_path))
        logging.info("Resume training.")
    else:
        logging.info("Start training.")
    trainer.train()
    logging.info("End training.")
    return trainer


def run_test(config: Config, device: str | None = None) -> dict:
    """Test as the config says; returns the predictor's log. ``device``
    overrides ``predictor.kwargs.device`` (whose default is ``cuda``)."""
    if not config.get("predictor"):
        raise ValueError(
            "--test needs a config with a predictor section (see "
            "configs/test/*.yaml); this one has none")
    predictor_kwargs = dict(config.predictor.get("kwargs") or {})
    device = device or predictor_kwargs.pop("device", None) or "cuda"
    predictor_kwargs["device"] = device

    logging.info("Create the testing dataset and dataloader.")
    test_dataset = build("dataset", config.dataset, type="test")
    dl_kwargs = dict(config.dataloader.get("kwargs") or {})
    dl_kwargs.pop("train_batch_size", None)
    dl_kwargs.pop("valid_batch_size", None)
    dl_kwargs.setdefault("batch_size", 1)
    test_loader = build(
        "loader", {"name": config.dataloader.name, "kwargs": dl_kwargs}, test_dataset
    )

    logging.info("Create the network architecture.")
    net = build_net(config, device)

    loss_fns, loss_weights = build_losses(config)
    metric_fns = build_metrics(config)

    logging.info("Create the predictor.")
    predictor = build(
        "predictor",
        {"name": config.predictor.name, "kwargs": predictor_kwargs},
        test_dataloader=test_loader,
        net=net,
        loss_fns=loss_fns,
        loss_weights=loss_weights,
        metric_fns=metric_fns,
    )

    if config.net.name != "Bicubic":
        logging.info(f'Load the previous checkpoint from "{config.main.loaded_path}".')
        predictor.load(Path(config.main.loaded_path))
    logging.info("Start testing.")
    log = predictor.predict()
    logging.info("End testing.")
    return log


def main(argv: list[str] | None = None) -> None:
    logging.basicConfig(
        format="%(asctime)s | %(levelname)s | %(message)s",
        level=logging.INFO,
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    parser = argparse.ArgumentParser(
        description="The script for the training and the testing.")
    parser.add_argument("config_path", type=Path, help="The path of the config file.")
    parser.add_argument("--test", action="store_true",
                        help="Perform testing instead of training.")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (cuda, cuda:1, cpu); "
                             "overrides trainer.kwargs.device / "
                             "predictor.kwargs.device (default cuda)")
    args = parser.parse_args(argv)

    config = load_config(args.config_path)
    logging.info(f'Loaded the config from "{args.config_path}".')
    if args.test:
        run_test(config, device=args.device)
    else:
        run_train(config, device=args.device)


if __name__ == "__main__":
    main()
