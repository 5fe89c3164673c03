"""Safe SG2-ADA ``.pkl`` (persistence-pickle) importer.

Port of ``montage_gan_tpu/utils/pkl_import.py`` (numpy and the unpickler,
copied; the port imports nothing of the JAX package).  Where the JAX
package goes through ``torch_import`` to flax layouts, the port's modules
carry the reference's state-dict names, so ``generator_from_pkl`` loads
them with a strict ``load_state_dict``.

The reference snapshots whole modules as "persistence pickles": each network
object pickles the *source code of its defining module* plus its state dict,
and unpickling re-executes that source (reference:
torch_utils/persistence.py:36-135, training/training_loop.py:383-395,
legacy.py:21-61).  Executing pickled source from an untrusted file is an
arbitrary-code-execution hazard, so this importer deliberately does NOT do
that.  Instead a restricted unpickler:

  * intercepts ``_reconstruct_persistent_obj`` and returns an inert
    ``ExtractedModule`` carrying the embedded state (``meta['state']`` is the
    module's ``__dict__``: ``_parameters`` / ``_buffers`` / ``_modules`` /
    construction kwargs) — the embedded ``module_src`` is never executed;
  * allowlists only the tensor/container rebuild callables (torch._utils,
    torch.storage, numpy, OrderedDict);
  * maps every other global to an inert placeholder that records its state.

From the extracted tree we rebuild the exact ``state_dict()`` name→tensor
mapping (the recursion mirrors ``nn.Module.state_dict`` naming) and the
``init_kwargs`` each persistent object was constructed with, which is enough
to re-instantiate the network in this framework.

Torch is required (storage decoding) but no reference code runs.
"""

from __future__ import annotations

import pickle
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np

_PERSISTENCE_FNS = {
    ('torch_utils.persistence', '_reconstruct_persistent_obj'),
}

# Tensor/container rebuild callables that are safe library internals.
_ALLOWED = {
    ('collections', 'OrderedDict'),
    ('torch._utils', '_rebuild_tensor'),
    ('torch._utils', '_rebuild_tensor_v2'),
    ('torch._utils', '_rebuild_parameter'),
    ('torch._utils', '_rebuild_wrapper_subclass'),
    ('torch.storage', '_load_from_bytes'),
    ('torch', 'Size'),
    ('torch', 'device'),
    ('torch.serialization', '_get_layout'),
    ('numpy.core.multiarray', '_reconstruct'),
    ('numpy._core.multiarray', '_reconstruct'),
    ('numpy.core.multiarray', 'scalar'),
    ('numpy._core.multiarray', 'scalar'),
    ('numpy', 'ndarray'),
    ('numpy', 'dtype'),
}


class ExtractedModule:
    """Inert stand-in for a persistence-pickled network module."""

    def __init__(self, meta: Dict[str, Any]):
        state = meta.get('state')
        if isinstance(state, dict):
            self.__dict__.update(state)
        self.__dict__['_persistent_class_name'] = meta.get('class_name')

    def __repr__(self):
        return f'<ExtractedModule {self._persistent_class_name}>'


class _Opaque:
    """Placeholder for any non-allowlisted global; records state only."""

    _pickle_origin = '?'

    def __init__(self, *args, **kwargs):
        pass

    # NEWOBJ protocol passes constructor args to __new__.
    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__['_state'] = state

    # dict-subclass pickles (dnnlib.EasyDict and friends) restore their
    # items through the mapping protocol; store them as attributes.
    def __setitem__(self, key, value):
        self.__dict__[key] = value

    def __getitem__(self, key):
        return self.__dict__[key]

    def get(self, key, default=None):
        return self.__dict__.get(key, default)

    def items(self):
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith('_')}.items()

    def __call__(self, *args, **kwargs):  # REDUCE on a "function" global
        if len(args) == 1 and isinstance(args[0], dict) \
                and 'class_name' in args[0] and 'state' in args[0]:
            return ExtractedModule(args[0])
        obj = _Opaque()
        obj.__dict__['_reduce_args'] = args
        return obj


class TFNetworkStub(_Opaque):
    """Inert stand-in for a TF1 ``dnnlib.tflib.network.Network`` pickle.

    TF1 StyleGAN pickles carry the network as plain data — 'version',
    'static_kwargs', 'components' (name → Network), 'variables'
    (list of (name, ndarray)) — plus build-function source that the
    reference would re-execute; here the source is inert (reference:
    legacy.py:66-77 `_TFNetworkStub`)."""


def _make_opaque(module: str, name: str):
    cls = type(name, (_Opaque,), {'_pickle_origin': f'{module}.{name}'})
    return cls


class _SafeUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _PERSISTENCE_FNS:
            return ExtractedModule
        if module == 'dnnlib.tflib.network' and name == 'Network':
            return TFNetworkStub
        if (module, name) in _ALLOWED:
            mod = __import__(module, fromlist=[name])
            return getattr(mod, name)
        # torch dtype/storage classes appear as bare globals in some formats;
        # resolving them is safe (classes, not called with attacker code).
        if module == 'torch' and (name.endswith('Storage')
                                  or name in ('float32', 'float16', 'float64',
                                              'int64', 'int32', 'uint8',
                                              'bfloat16', 'bool')):
            import torch
            return getattr(torch, name)
        return _make_opaque(module, name)


def safe_load(path: str) -> Any:
    """Unpickle ``path`` without executing embedded source/arbitrary globals."""
    with open(path, 'rb') as f:
        return _SafeUnpickler(f).load()


def _to_np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, 'detach') else t)


def module_state_dict(obj: Any, prefix: str = '',
                      out: Optional[Dict[str, np.ndarray]] = None
                      ) -> Dict[str, np.ndarray]:
    """Rebuild the torch ``state_dict()`` name→array mapping from an
    extracted module tree (same naming recursion as nn.Module)."""
    if out is None:
        out = {}
    d = getattr(obj, '__dict__', {})
    for coll in ('_parameters', '_buffers'):
        for name, t in (d.get(coll) or {}).items():
            if t is not None:
                out[prefix + name] = _to_np(t)
    for name, child in (d.get('_modules') or {}).items():
        if child is not None:
            module_state_dict(child, prefix + name + '.', out)
    return out


def init_kwargs_of(obj: Any) -> Dict[str, Any]:
    """Construction kwargs recorded by the persistence decorator
    (reference: torch_utils/persistence.py init_args/init_kwargs)."""
    d = getattr(obj, '__dict__', {})
    kwargs = dict(d.get('_init_kwargs') or {})
    args = list(d.get('_init_args') or ())
    if args:
        kwargs['__init_args__'] = args
    return kwargs


# ---------------------------------------------------------------------------
# TF1 (StyleGAN/StyleGAN2) pickle conversion — mirror of legacy.py:80-320,
# without TensorFlow or executing the pickled build source.
# ---------------------------------------------------------------------------

def _as_dict(obj) -> Dict[str, Any]:
    """static_kwargs / components arrive as EasyDict placeholders."""
    if isinstance(obj, dict):
        return dict(obj)
    if isinstance(obj, _Opaque):
        return {k: v for k, v in obj.__dict__.items()
                if not k.startswith('_')}
    return {}


def _collect_tf_params(stub) -> Dict[str, np.ndarray]:
    """Flatten (name, value) variables across nested components
    (reference: legacy.py:79-90)."""
    out: Dict[str, np.ndarray] = {}

    def recurse(prefix, net):
        for name, value in getattr(net, 'variables', []) or []:
            out[prefix + name] = np.asarray(value)
        for name, comp in _as_dict(getattr(net, 'components', {})).items():
            recurse(prefix + name + '/', comp)

    recurse('', stub)
    return out


def _tf_conv(v: np.ndarray, flip: bool = False) -> np.ndarray:
    """TF [kh, kw, in, out] → torch [out, in, kh, kw], optionally spatially
    flipped (the Conv0_up/Skip cases, legacy.py:196,221)."""
    if flip:
        v = v[::-1, ::-1]
    return np.ascontiguousarray(v.transpose(3, 2, 0, 1))


def convert_tf_generator(stub) -> Dict[str, Any]:
    """TF Generator stub → {'class_name', 'init_kwargs', 'state_dict'} with
    torch-reference names/layouts (reference: legacy.py:117-227)."""
    if getattr(stub, 'version', 0) < 4:
        raise ValueError('TensorFlow pickle version too low')
    tf_kwargs = _as_dict(stub.static_kwargs)
    known = set()

    def kwarg(name, default=None, none=None):
        known.add(name)
        val = tf_kwargs.get(name, default)
        return val if val is not None else none

    kwargs = dict(
        z_dim=kwarg('latent_size', 512),
        c_dim=kwarg('label_size', 0),
        w_dim=kwarg('dlatent_size', 512),
        img_resolution=kwarg('resolution', 1024),
        img_channels=kwarg('num_channels', 3),
        mapping_kwargs=dict(
            num_layers=kwarg('mapping_layers', 8),
            embed_features=kwarg('label_fmaps', None),
            layer_features=kwarg('mapping_fmaps', None),
            activation=kwarg('mapping_nonlinearity', 'lrelu'),
            lr_multiplier=kwarg('mapping_lrmul', 0.01),
            w_avg_beta=kwarg('w_avg_beta', 0.995, none=1),
        ),
        synthesis_kwargs=dict(
            channel_base=kwarg('fmap_base', 16384) * 2,
            channel_max=kwarg('fmap_max', 512),
            num_fp16_res=kwarg('num_fp16_res', 0),
            conv_clamp=kwarg('conv_clamp', None),
            architecture=kwarg('architecture', 'skip'),
            resample_filter=kwarg('resample_kernel', [1, 3, 3, 1]),
            use_noise=kwarg('use_noise', True),
            activation=kwarg('nonlinearity', 'lrelu'),
        ),
    )
    for ignored in ('truncation_psi', 'truncation_cutoff',
                    'style_mixing_prob', 'structure'):
        known.add(ignored)
    unknown = set(tf_kwargs) - known
    if unknown:
        raise ValueError(f'Unknown TensorFlow kwarg {sorted(unknown)[0]!r}')

    p = _collect_tf_params(stub)
    # very old pickles: per-lod ToRGB (legacy.py:172-177)
    for name in list(p):
        m = re.fullmatch(r'ToRGB_lod(\d+)/(.*)', name)
        if m:
            r = kwargs['img_resolution'] // (2 ** int(m.group(1)))
            p[f'{r}x{r}/ToRGB/{m.group(2)}'] = p[name]
            kwargs['synthesis_kwargs']['architecture'] = 'orig'

    sd: Dict[str, np.ndarray] = {'mapping.w_avg': np.asarray(p['dlatent_avg'])}
    if 'mapping/LabelEmbed/weight' in p:
        sd['mapping.embed.weight'] = p['mapping/LabelEmbed/weight'].T
        sd['mapping.embed.bias'] = p['mapping/LabelEmbed/bias']
    for i in range(kwargs['mapping_kwargs']['num_layers']):
        sd[f'mapping.fc{i}.weight'] = p[f'mapping/Dense{i}/weight'].T
        sd[f'mapping.fc{i}.bias'] = p[f'mapping/Dense{i}/bias']

    res = kwargs['img_resolution']
    num_res = int(np.log2(res)) - 1  # blocks at 4..res
    sd['synthesis.b4.const'] = np.asarray(p['synthesis/4x4/Const/const'][0])

    def conv(dst, src, noise_idx=None, flip=False):
        sd[f'{dst}.weight'] = _tf_conv(p[f'{src}/weight'], flip=flip)
        sd[f'{dst}.bias'] = p[f'{src}/bias']
        sd[f'{dst}.affine.weight'] = p[f'{src}/mod_weight'].T
        sd[f'{dst}.affine.bias'] = p[f'{src}/mod_bias'] + 1
        # Pickles saved with use_noise=False carry no noise buffers/strength;
        # only populate the params that exist (the reference converter only
        # fills params present in the instantiated module, legacy.py:221-225).
        if noise_idx is not None and f'synthesis/noise{noise_idx}' in p:
            sd[f'{dst}.noise_const'] = np.asarray(
                p[f'synthesis/noise{noise_idx}'][0, 0])
        if noise_idx is not None and f'{src}/noise_strength' in p:
            sd[f'{dst}.noise_strength'] = np.asarray(
                p[f'{src}/noise_strength'])

    conv('synthesis.b4.conv1', 'synthesis/4x4/Conv', noise_idx=0)
    for li in range(1, num_res):
        r = 4 << li
        lg = int(np.log2(r))
        conv(f'synthesis.b{r}.conv0', f'synthesis/{r}x{r}/Conv0_up',
             noise_idx=lg * 2 - 5, flip=True)
        conv(f'synthesis.b{r}.conv1', f'synthesis/{r}x{r}/Conv1',
             noise_idx=lg * 2 - 4)
        if f'synthesis/{r}x{r}/Skip/weight' in p:
            sd[f'synthesis.b{r}.skip.weight'] = _tf_conv(
                p[f'synthesis/{r}x{r}/Skip/weight'], flip=True)
    for li in range(num_res):
        r = 4 << li
        src = f'synthesis/{r}x{r}/ToRGB'
        if f'{src}/weight' in p:
            sd[f'synthesis.b{r}.torgb.weight'] = _tf_conv(p[f'{src}/weight'])
            sd[f'synthesis.b{r}.torgb.bias'] = p[f'{src}/bias']
            sd[f'synthesis.b{r}.torgb.affine.weight'] = p[f'{src}/mod_weight'].T
            sd[f'synthesis.b{r}.torgb.affine.bias'] = p[f'{src}/mod_bias'] + 1
    return dict(class_name='training.networks.Generator',
                init_kwargs=kwargs, state_dict=sd)


def convert_tf_discriminator(stub) -> Dict[str, Any]:
    """TF Discriminator stub → torch-reference names/layouts
    (reference: legacy.py:235-320)."""
    if getattr(stub, 'version', 0) < 4:
        raise ValueError('TensorFlow pickle version too low')
    tf_kwargs = _as_dict(stub.static_kwargs)
    known = {'structure'}

    def kwarg(name, default=None):
        known.add(name)
        return tf_kwargs.get(name, default)

    kwargs = dict(
        c_dim=kwarg('label_size', 0),
        img_resolution=kwarg('resolution', 1024),
        img_channels=kwarg('num_channels', 3),
        architecture=kwarg('architecture', 'resnet'),
        channel_base=kwarg('fmap_base', 16384) * 2,
        channel_max=kwarg('fmap_max', 512),
        num_fp16_res=kwarg('num_fp16_res', 0),
        conv_clamp=kwarg('conv_clamp', None),
        cmap_dim=kwarg('mapping_fmaps', None),
        block_kwargs=dict(
            activation=kwarg('nonlinearity', 'lrelu'),
            resample_filter=kwarg('resample_kernel', [1, 3, 3, 1]),
            freeze_layers=kwarg('freeze_layers', 0),
        ),
        mapping_kwargs=dict(
            num_layers=kwarg('mapping_layers', 0),
            embed_features=kwarg('mapping_fmaps', None),
            layer_features=kwarg('mapping_fmaps', None),
            activation=kwarg('nonlinearity', 'lrelu'),
            lr_multiplier=kwarg('mapping_lrmul', 0.1),
        ),
        epilogue_kwargs=dict(
            mbstd_group_size=kwarg('mbstd_group_size', None),
            mbstd_num_channels=kwarg('mbstd_num_features', 1),
            activation=kwarg('nonlinearity', 'lrelu'),
        ),
    )
    unknown = set(tf_kwargs) - known
    if unknown:
        raise ValueError(f'Unknown TensorFlow kwarg {sorted(unknown)[0]!r}')

    p = _collect_tf_params(stub)
    for name in list(p):
        m = re.fullmatch(r'FromRGB_lod(\d+)/(.*)', name)
        if m:
            r = kwargs['img_resolution'] // (2 ** int(m.group(1)))
            p[f'{r}x{r}/FromRGB/{m.group(2)}'] = p[name]
            kwargs['architecture'] = 'orig'

    sd: Dict[str, np.ndarray] = {}
    res = kwargs['img_resolution']
    for li in range(int(np.log2(res)) - 2):
        r = res >> li
        if f'{r}x{r}/FromRGB/weight' in p:
            sd[f'b{r}.fromrgb.weight'] = _tf_conv(p[f'{r}x{r}/FromRGB/weight'])
            sd[f'b{r}.fromrgb.bias'] = p[f'{r}x{r}/FromRGB/bias']
        sd[f'b{r}.conv0.weight'] = _tf_conv(p[f'{r}x{r}/Conv0/weight'])
        sd[f'b{r}.conv0.bias'] = p[f'{r}x{r}/Conv0/bias']
        sd[f'b{r}.conv1.weight'] = _tf_conv(p[f'{r}x{r}/Conv1_down/weight'])
        sd[f'b{r}.conv1.bias'] = p[f'{r}x{r}/Conv1_down/bias']
        if f'{r}x{r}/Skip/weight' in p:
            sd[f'b{r}.skip.weight'] = _tf_conv(p[f'{r}x{r}/Skip/weight'])
    if 'LabelEmbed/weight' in p:
        sd['mapping.embed.weight'] = p['LabelEmbed/weight'].T
        sd['mapping.embed.bias'] = p['LabelEmbed/bias']
    i = 0
    while f'Mapping{i}/weight' in p:
        sd[f'mapping.fc{i}.weight'] = p[f'Mapping{i}/weight'].T
        sd[f'mapping.fc{i}.bias'] = p[f'Mapping{i}/bias']
        i += 1
    sd['b4.conv.weight'] = _tf_conv(p['4x4/Conv/weight'])
    sd['b4.conv.bias'] = p['4x4/Conv/bias']
    sd['b4.fc.weight'] = p['4x4/Dense0/weight'].T
    sd['b4.fc.bias'] = p['4x4/Dense0/bias']
    sd['b4.out.weight'] = p['Output/weight'].T
    sd['b4.out.bias'] = p['Output/bias']
    return dict(class_name='training.networks.Discriminator',
                init_kwargs=kwargs, state_dict=sd)




def load_network_pkl(path: str) -> Dict[str, Any]:
    """Load a reference training snapshot ``.pkl`` → for each network key
    ('G', 'D', 'G_ema', 'augment_pipe'): {'state_dict', 'init_kwargs',
    'class_name'}; other keys pass through as plain values.

    Covers both branches of the reference's ``legacy.load_network_pkl``
    (legacy.py:21-61): PyTorch persistence pickles, and legacy TF1 pickles —
    a (G, D, Gs) tuple of ``dnnlib.tflib.network.Network`` — converted via
    the same name-remapping tables (legacy.py:117-320) without executing
    any pickled source.
    """
    data = safe_load(path)
    if (isinstance(data, tuple) and len(data) == 3
            and all(isinstance(n, TFNetworkStub) for n in data)):
        tf_g, tf_d, tf_gs = data
        return dict(G=convert_tf_generator(tf_g),
                    D=convert_tf_discriminator(tf_d),
                    G_ema=convert_tf_generator(tf_gs),
                    training_set_kwargs=None, augment_pipe=None)
    if not isinstance(data, dict):
        raise ValueError(f'{path}: expected a dict snapshot pickle')
    out: Dict[str, Any] = {}
    for key, val in data.items():
        if isinstance(val, ExtractedModule):
            out[key] = dict(
                class_name=val._persistent_class_name,
                init_kwargs=init_kwargs_of(val),
                state_dict=module_state_dict(val))
        else:
            out[key] = val
    return out


def generator_modules(kw: Dict[str, Any]):
    """(MappingNetwork, SynthesisNetwork) of the port for a reference
    ``Generator``'s construction kwargs (the JAX ``generator_from_pkl``'s
    fields).  The port's synthesis is the 'skip' architecture alone."""
    from ..models.mapping import MappingNetwork
    from ..models.synthesis import SynthesisNetwork
    syn_kw = dict(kw.get('synthesis_kwargs') or {})
    map_kw = dict(kw.get('mapping_kwargs') or {})
    if syn_kw.get('architecture', 'skip') != 'skip':
        raise NotImplementedError(
            f'synthesis architecture {syn_kw["architecture"]!r}: the port '
            "has the 'skip' architecture only")
    syn_fields = {k: syn_kw[k] for k in
                  ('channel_base', 'channel_max', 'num_fp16_res',
                   'conv_clamp', 'conv_config_index') if k in syn_kw}
    if 'init_res' in syn_kw:
        syn_fields['init_res'] = tuple(syn_kw['init_res'])
    synthesis = SynthesisNetwork(img_resolution=kw['img_resolution'],
                                 img_channels=kw['img_channels'],
                                 w_dim=kw['w_dim'], **syn_fields)
    mapping = MappingNetwork(z_dim=kw['z_dim'], c_dim=kw.get('c_dim', 0) or 0,
                             w_dim=kw['w_dim'], num_ws=synthesis.num_ws,
                             **{k: map_kw[k] for k in
                                ('num_layers', 'embed_features',
                                 'layer_features') if k in map_kw})
    return mapping, synthesis


def generator_from_pkl(path: str, key: str = 'G_ema'):
    """SG2-ADA pkl → (mapping, synthesis, init_kwargs): the port's modules
    rebuilt from the construction kwargs the persistence decorator recorded
    and loaded by a strict ``load_state_dict`` of the reference's names
    (reference loader contract: legacy.py:21-61, generate.py:86-87), on the
    CPU in eval mode."""
    import torch
    net = load_network_pkl(path)[key]
    kw = net['init_kwargs']
    mapping, synthesis = generator_modules(kw)
    sd = net['state_dict']
    for prefix, module in (('mapping.', mapping), ('synthesis.', synthesis)):
        load_reference_state(module, {
            k[len(prefix):]: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in sd.items() if k.startswith(prefix)}, path)
        module.eval().requires_grad_(False)
    return mapping, synthesis, kw


def load_reference_state(module, state_dict, name: str = '') -> None:
    """``module.load_state_dict(state_dict)``, strict but for the
    ``resample_filter`` buffers, which a TF1 conversion does not carry
    (they are the constant ``setup_filter([1, 3, 3, 1])``)."""
    result = module.load_state_dict(state_dict, strict=False)
    missing = [k for k in result.missing_keys
               if not k.endswith('resample_filter')]
    if missing or result.unexpected_keys:
        raise KeyError(f'{name}: missing {missing}, unexpected '
                       f'{result.unexpected_keys}')


def _jax_path(net: str, key: str) -> Optional[Tuple[str, ...]]:
    """The path in the JAX package's variable tree of a reference state-dict
    entry of a mapping, a synthesis network or a D (``net``), as
    ``torch_import`` converts it; None for what it drops (the
    ``resample_filter`` constants, a D mapping's ``w_avg``)."""
    parts = tuple(key.split('.'))
    if parts[-1] == 'resample_filter':
        return None
    if net == 'mapping':
        return (('moving_stats', 'w_avg') if key == 'w_avg'
                else ('params', *parts))
    if net == 'synthesis' and parts[-1] == 'noise_const':
        return ('noise', *parts)
    if net == 'd' and key == 'mapping.w_avg':
        return None
    return ('params', *parts)


def _transfer(module, src: Dict[str, Any], net: str, label: str,
              copied: list, skipped: list) -> None:
    """Copy the entries of the reference state dict ``src`` into ``module``
    where the name exists and the shape matches, counting as the JAX
    package's ``_merge_matching_leaves`` counts (``pkl_import.py:
    467-486``): a copied tensor, a tensor of another shape, and once each
    subtree of the JAX tree that the module lacks."""
    import torch
    own = module.state_dict()
    dst = {}
    for k, t in own.items():
        path = _jax_path(net, k)
        if path is not None:
            dst[path] = t
    prefixes = {p[:i] for p in dst for i in range(1, len(p))}
    missing = set()
    for key, value in src.items():
        path = _jax_path(net, key)
        if path is None:
            continue
        where = '.'.join((label, *path))
        if path in dst:
            value = np.asarray(value, np.float32)
            if tuple(dst[path].shape) == value.shape:
                with torch.no_grad():
                    dst[path].copy_(torch.from_numpy(value))
                copied.append(where)
            else:
                skipped.append(where)
            continue
        for i in range(1, len(path) + 1):
            if path[:i] not in prefixes and path[:i] not in dst:
                missing.add('.'.join((label, *path[:i])))
                break
        else:
            skipped.append(where)    # a leaf where the module has a subtree
    skipped.extend(sorted(missing))


def transfer_into_train_state(state, path: str, verbose: bool = True):
    """SG2-ADA snapshot ``.pkl`` → a single-GAN train state: the G, D and
    G_ema entries copied into the live mapping and synthesis, ``local_d[0]``
    and the EMA, in place (the reference's transfer-learning resume:
    legacy.load_network_pkl + copy_params_and_buffers into G/D/G_ema,
    training/training_loop.py:166-172; the JAX package's
    ``transfer_into_train_state``).  An entry whose shape differs keeps its
    initialized value (transfer across resolutions); the printed counts are
    the JAX function's.  Returns the state."""
    data = load_network_pkl(path)
    copied: list = []
    skipped: list = []

    def reference(key):
        net = data.get(key)
        return net['state_dict'] if (isinstance(net, dict)
                                     and 'state_dict' in net) else None

    def split(sd, prefix):
        return {k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix)}

    for key, ens in (('G', state.model), ('G_ema', state.ema)):
        sd = reference(key)
        if sd is None:
            continue
        _transfer(ens.mapping, split(sd, 'mapping.'), 'mapping',
                  f'{key}.mapping', copied, skipped)
        _transfer(ens.local_g[0], split(sd, 'synthesis.'), 'synthesis',
                  f'{key}.synthesis', copied, skipped)
        if key == 'G':
            d = reference('D')
            if d is not None:
                _transfer(state.model.local_d[0], d, 'd', 'D', copied,
                          skipped)
    if verbose:
        print(f'transfer_into_train_state: copied {len(copied)} tensors, '
              f'skipped {len(skipped)}')
    return state
