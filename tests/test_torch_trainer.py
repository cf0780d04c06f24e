"""The PyTorch port's trainer around the steps, against the JAX package on
the CPU: the datasets' pixels, the threaded loader, sample grids, the step
timer and the log record, the batches each iteration draws, and save /
load / resume."""

import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

from gigagan_tpu.data import datasets as jdata  # noqa: E402
from gigagan_tpu.train import trainer as jtrainer  # noqa: E402
from gigagan_tpu.utils.profiling import StepTimer as JaxStepTimer  # noqa: E402

from gigagan_tpu_torch import GigaGAN  # noqa: E402
from gigagan_tpu_torch.data import (  # noqa: E402
    DataLoader,
    ImageDataset,
    MockImageDataset,
    SyntheticShapesDataset,
)
from gigagan_tpu_torch.train.trainer import save_image_grid  # noqa: E402
from gigagan_tpu_torch.utils import StepTimer  # noqa: E402

G_CFG = dict(image_size=16, dim_capacity=4, dim_max=32, dim_latent=16,
             style_network=dict(dim=16, depth=1), self_attn_resolutions=(),
             num_conv_kernels=2, num_skip_layers_excite=1,
             unconditional=True)
D_CFG = dict(image_size=16, dim_capacity=4, dim_max=32, attn_resolutions=(),
             num_skip_layers_excite=1, unconditional=True)
BATCH = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_gan(tmp_path, **kwargs):
    kwargs.setdefault("seed", 0)
    kwargs.setdefault("log_steps_every", 100)
    return GigaGAN(generator=G_CFG, discriminator=D_CFG, device="cpu",
                   results_folder=tmp_path / "results",
                   model_folder=tmp_path / "models", **kwargs)


def loader(length=8, **kwargs):
    return MockImageDataset(16, length=length).get_dataloader(BATCH, **kwargs)


# ------------------------------------------------------------------- data

def test_synthetic_shapes_give_the_jax_pixels():
    for channels in (3, 1):
        ours = SyntheticShapesDataset(32, seed=7, channels=channels)
        theirs = jdata.SyntheticShapesDataset(32, seed=7, channels=channels)
        for i in (0, 3, 511):
            np.testing.assert_array_equal(ours[i], theirs[i])


def write_images(folder, n, rng):
    """n images of assorted sizes and formats (a few JPEGs, one grey)."""
    folder.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        w, h = int(rng.integers(18, 40)), int(rng.integers(18, 40))
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        img = Image.fromarray(arr)
        if i % 17 == 0:
            img = img.convert("L")
        ext = "jpg" if i % 10 == 3 else "png"
        sub = folder / ("nested" if i % 2 else "")
        sub.mkdir(exist_ok=True)
        img.save(sub / f"{i:03d}.{ext}")


def test_image_dataset_gives_the_jax_pixels(tmp_path):
    write_images(tmp_path / "images", 101, np.random.default_rng(0))
    kw = dict(augment_horizontal_flip=True, seed=3)
    ours = ImageDataset(tmp_path / "images", 16, **kw)
    theirs = jdata.ImageDataset(tmp_path / "images", 16, **kw)
    assert len(ours) == len(theirs) == 101
    # the flips come from (seed, index, call number): the same calls in the
    # same order give the same pixels, a second pass new flips
    for i in [0, 3, 17, 50, 100] * 2:
        got, want = ours[i], theirs[i]
        assert got.shape == (16, 16, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    write_images(tmp_path / "few", 100, np.random.default_rng(1))
    with pytest.raises(AssertionError, match="at least 100"):
        ImageDataset(tmp_path / "few", 16)


def test_threaded_loader_keeps_the_order_and_its_threads():
    data = MockImageDataset(8, length=22)
    plain = DataLoader(data, 3, shuffle=True, seed=4, num_workers=0,
                       prefetch=0)
    threaded = DataLoader(data, 3, shuffle=True, seed=4, num_workers=4,
                          prefetch=2)
    for _ in range(2):  # a new permutation each pass, alike
        a, b = list(plain), list(threaded)
        assert len(a) == len(b) == 8 and b[-1].shape == (1, 8, 8, 3)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    # a consumer that stops early ends the producer and the decode threads
    before = threading.active_count()
    it = iter(threaded)
    next(it)
    it.close()
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before

    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise ValueError(f"item {i} is broken")

    with pytest.raises(ValueError, match="broken"):
        list(DataLoader(Broken(), 2))


# ------------------------------------------------- grids, timer, log record

@pytest.mark.parametrize("channels", [3, 1])
def test_save_image_grid_gives_the_jax_pixels(tmp_path, channels):
    images = np.random.default_rng(2).random((5, 6, 7, channels)).astype(
        np.float32)
    ours, theirs = tmp_path / "ours.png", tmp_path / "theirs.png"
    save_image_grid(images, ours, nrow=2)
    jtrainer.save_image_grid(images, theirs, nrow=2)
    got, want = (np.asarray(Image.open(p)) for p in (ours, theirs))
    assert got.shape == want.shape == ((3 * 6 + 4 * 2, 2 * 7 + 3 * 2)
                                       + ((3,) if channels == 3 else ()))
    np.testing.assert_array_equal(got, want)


def test_step_timer_matches_jax():
    ours, theirs = StepTimer(window=2), JaxStepTimer(window=2)
    assert ours.summary(8) == theirs.summary(8) == "no steps timed"
    for elapsed, n in ((0.5, 2), (0.3, 1), (0.0, 0), (1.2, 4)):
        ours.record(elapsed, n)
        theirs.record(elapsed, n)
        assert ours.mean_s == theirs.mean_s
        assert ours.images_per_sec(8) == theirs.images_per_sec(8)
        assert ours.summary(8) == theirs.summary(8)
        assert ours.summary() == theirs.summary()
    ours.start()
    ours.stop(3)
    assert len(ours.intervals) == 2 and ours.intervals[-1][1] == 3


def jax_record_keys():
    """The keys of the JAX trainer's log_hook record, from its source."""
    src = Path(jtrainer.__file__).read_text()
    pairs = re.search(r"pairs = \((.*?)\n\s+\)\n", src, re.S).group(1)
    hook = re.search(r"self\.log_hook\(\{(.*?)\}\)", src, re.S).group(1)
    return (re.findall(r'"(\w+)"', hook)[:1] + re.findall(r'\("(\w+)",',
                                                           pairs)
            + re.findall(r'"(\w+)":', hook)[1:])


def test_log_hook_record_has_the_jax_keys(tmp_path, capsys):
    records = []
    gan = small_gan(tmp_path, log_hook=records.append, log_steps_every=2)
    gan.set_dataloader(loader())
    log = gan.train(6)
    keys = jax_record_keys()
    assert keys[:2] == ["step", "G"] and keys[-2:] == ["ms_per_step",
                                                       "images_per_sec"]
    assert [list(r) for r in records] == [keys] * 4
    assert [r["step"] for r in records] == [r["step"] for r in log] == [
        1, 2, 4, 6]
    # the last R1 value is carried over to the steps without one
    assert records[2]["GP"] == log[2]["d_gradient_penalty"] > 0
    assert records[3]["GP"] == records[2]["GP"]
    assert log[3]["d_gradient_penalty"] == 0.0
    assert all(r["ms_per_step"] > 0 and r["images_per_sec"] > 0
               for r in records)
    out = capsys.readouterr().out
    assert re.search(r"step 4: G: \S+ \| MSG: \S+ \| VG: 0\.00 \| D: \S+ \| "
                     r"MSD: \S+ \| VD: 0\.00 \| GP: \S+ \| SSL: \S+ \| "
                     r"CL: 0\.00 \| MAL: 0\.00 \| \S+ ms/step \(\S+ img/s\)",
                     out), out


class CountingLoader:
    """A dataloader that counts the batches drawn from it."""

    def __init__(self, dl):
        self.dl, self.drawn = dl, 0
        self.batch_size = dl.batch_size

    def __iter__(self):
        for batch in self.dl:
            self.drawn += 1
            yield batch


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
@pytest.mark.parametrize("accum", [1, 2])
def test_each_iteration_draws_the_jax_batches(tmp_path, fused, accum):
    # as GigaGAN.forward of the JAX trainer: grad_accum_every batches for
    # the d_step and as many for the g_step, none for the g_step when it
    # reuses the d_step's (fused_dg_step)
    gan = small_gan(tmp_path, fused_dg_step=fused)
    counting = CountingLoader(loader(length=16))
    gan.set_dataloader(counting)
    gan.train(3, grad_accum_every=accum)
    assert counting.drawn == 3 * accum * (1 if fused else 2)
    assert gan.steps == 4 and gan.ema.step == 3


def test_save_and_sample_cadence(tmp_path):
    gan = small_gan(tmp_path, save_and_sample_every=4,
                    early_save_thres_steps=2, early_save_and_sample_every=2,
                    num_samples=5)
    gan.set_dataloader(loader())
    gan.train(8)
    # step 1, the early step 2, then every 4th: milestones 0, 0, 1, 2
    results = sorted(p.name for p in (tmp_path / "results").iterdir())
    assert results == [f"{k}-{m}.png" for k in ("ema-sample", "sample")
                       for m in (0, 1, 2)]
    grid = np.asarray(Image.open(tmp_path / "results" / "sample-2.png"))
    assert grid.shape == (3 * 16 + 4 * 2, 2 * 16 + 3 * 2, 3)  # 5 in rows of 2
    assert sorted(p.name for p in (tmp_path / "models").iterdir()) == [
        "model-0.ckpt", "model-1.ckpt", "model-2.ckpt"]


# ---------------------------------------------------------- save and load

def one_iteration(gan):
    real = np.random.default_rng(5).random((BATCH, 16, 16, 3)).astype(
        np.float32)
    gan.train_discriminator_step(real, apply_gradient_penalty=True,
                                 calc_multiscale_loss=True)
    gan.train_generator_step(BATCH, calc_multiscale_loss=True)


def trainer_state(gan):
    state = {f"{m}.{k}": v.clone() for m in ("G", "G_ema", "D")
             for k, v in getattr(gan, m).state_dict().items()}
    for name in ("g_opt", "d_opt"):
        for i, s in getattr(gan, name).state_dict()["state"].items():
            state.update({f"{name}.{i}.{k}": v.clone() for k, v in s.items()})
    return state


def test_resume_matches_an_uninterrupted_run(tmp_path):
    gan = small_gan(tmp_path, create_ema_generator_at_init=False)
    gan.set_dataloader(loader())
    gan.train(3)
    gan.create_ema_generator(update_every=2, update_after_step=0, decay=0.9)
    gan.train(2)
    gan.save(tmp_path / "resume.ckpt")
    resumed = small_gan(tmp_path, seed=1)
    resumed.load(tmp_path / "resume.ckpt", strict=True)
    assert resumed.steps == gan.steps == 6
    assert (resumed.ema.step, resumed.ema.initted, resumed.ema.beta) == (
        gan.ema.step, gan.ema.initted, 0.9)
    # the next iteration draws its seeds from the restored numpy RNG
    for trainer in (gan, resumed):
        one_iteration(trainer)
    want, got = trainer_state(gan), trainer_state(resumed)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    np.testing.assert_array_equal(resumed.generate(batch_size=2),
                                  gan.generate(batch_size=2))


def test_tolerant_load_keeps_what_does_not_fit(tmp_path, capsys):
    gan = small_gan(tmp_path)
    gan.set_dataloader(loader())
    gan.train(2)
    gan.save(tmp_path / "good.ckpt")
    saved = torch.load(tmp_path / "good.ckpt", weights_only=True)
    name = next(iter(saved["D"]))
    saved["D"][name] = torch.zeros(3)  # a tensor of another shape
    saved["d_opt"]["state"][0]["exp_avg"] = torch.zeros(5)  # a misfit
    torch.save(saved, tmp_path / "bad.ckpt")

    fresh = small_gan(tmp_path, seed=1)
    live = fresh.D.state_dict()[name].clone()
    fresh.load(tmp_path / "bad.ckpt")
    out = capsys.readouterr().out
    assert f"kept live values for 1 incompatible entries (first: D.{name}" \
        in out and "unable to load d_opt state" in out
    assert torch.equal(fresh.D.state_dict()[name], live)
    for k, v in gan.D.state_dict().items():
        if k != name:
            assert torch.equal(fresh.D.state_dict()[k], v), k
    assert not fresh.d_opt.state  # reset fresh
    for k, v in trainer_state(gan).items():
        if k.startswith("g_opt"):
            assert torch.equal(trainer_state(fresh)[k], v), k
    assert fresh.steps == gan.steps
    with pytest.raises(RuntimeError, match="does not match"):
        small_gan(tmp_path).load(tmp_path / "bad.ckpt", strict=True)
    # a trainer without an EMA takes none from the checkpoint, and says so
    plain = small_gan(tmp_path, create_ema_generator_at_init=False)
    with pytest.raises(RuntimeError, match="ema"):
        plain.load(tmp_path / "good.ckpt", strict=True)
    plain.load(tmp_path / "good.ckpt")
    assert plain.ema is None


def test_create_ema_generator_starts_from_g(tmp_path):
    gan = small_gan(tmp_path, create_ema_generator_at_init=False)
    gan.set_dataloader(loader())
    gan.train(1)
    assert not gan.has_ema_generator
    gan.create_ema_generator(update_every=1, update_after_step=0)
    assert gan.has_ema_generator and gan.builder.ema is gan.ema
    for p, q in zip(gan.G.parameters(), gan.G_ema.parameters()):
        assert torch.equal(p, q)
    with pytest.raises(AssertionError, match="already created"):
        gan.create_ema_generator()
    gan.train(1)
    assert gan.ema.step == 1
