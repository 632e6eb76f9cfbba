// Compiled TLV wire codec — the C twin of adlb_tpu_torch/runtime/codec.py's
// encode_binary_iov / decode_binary (which remain the authoritative
// fallback twin; the parity fuzz in tests/test_codec_fuzz.py holds the
// two byte-identical).
//
// Loaded with ctypes.PyDLL, like the queue core, for a whole hot path:
// the GIL stays held
// (these functions manipulate PyObjects and never block or do I/O), so a
// call costs a plain C call instead of a GIL bounce, and the CPython API
// is usable directly. Python header/ABI only; no pip, no setuptools —
// built by adlb_tpu_torch/native/build.py::ensure_codec with the system g++,
// exactly like wqcore.
//
// Layout contract (keep in sync with codec.py, the module docstring
// there is the registry of record):
//
//   u8  magic 0x01 | u16 tag | i32 src | u16 nfields
//   per field: u8 fid | u8 kind | value
//   kinds: 0=i64, 1=bytes(u32 len+data), 2=i64 list(u16 cnt+i64*),
//          3=f64, 4=bytes list(u16 cnt,(u32 len+data)*), 5=f64 list
//
// All integers little-endian; this file memcpy's scalars directly and is
// gated to little-endian hosts at build time (the same x86-64 assumption
// the shm ring's TSO publish discipline already bakes in).

#include <Python.h>

#include <cstdint>
#include <cstring>

#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
#error "compiled TLV codec requires a little-endian host"
#endif

namespace {

enum Kind {
    K_I64 = 0,
    K_BYTES = 1,
    K_LIST = 2,
    K_F64 = 3,
    K_BLIST = 4,
    K_FLIST = 5,
};

// bytes fields at least this large ride the iovec as zero-copy parts
// (codec.py IOV_INLINE_MAX — set from Python at setup so the twins can
// never drift)
Py_ssize_t g_inline_max = 512;

// encode table: field-name str -> PyLong((fid << 8) | kind); the key
// objects are the very strings codec.py's FIELDS holds, so lookups hit
// the interned-pointer fast path inside PyDict_GetItem
PyObject* g_field_ids = nullptr;
// decode table: fid -> (owned name str, kind); absent = unknown field
// (parsed and skipped, not fatal — codec.py semantics)
struct FieldInfo {
    PyObject* name;
    int kind;
};
FieldInfo g_by_fid[256];

// ---------------------------------------------------------------- writer

struct Enc {
    char* buf;
    Py_ssize_t len, cap;
    PyObject* parts;  // list[bytes | original big-payload object]

    bool reserve(Py_ssize_t n) {
        if (len + n <= cap) return true;
        Py_ssize_t want = cap ? cap * 2 : 1024;
        while (want < len + n) want *= 2;
        char* nb = static_cast<char*>(PyMem_Realloc(buf, want));
        if (!nb) {
            PyErr_NoMemory();
            return false;
        }
        buf = nb;
        cap = want;
        return true;
    }
    bool put(const void* p, Py_ssize_t n) {
        if (!reserve(n)) return false;
        memcpy(buf + len, p, n);
        len += n;
        return true;
    }
    bool u8(uint8_t v) { return put(&v, 1); }
    bool u16(uint16_t v) { return put(&v, 2); }
    bool u32(uint32_t v) { return put(&v, 4); }
    bool i32(int32_t v) { return put(&v, 4); }
    bool i64(int64_t v) { return put(&v, 8); }
    bool f64(double v) { return put(&v, 8); }

    // seal the accumulated segment into parts (no-op when empty)
    bool flush() {
        if (!len) return true;
        PyObject* b = PyBytes_FromStringAndSize(buf, len);
        if (!b) return false;
        int rc = PyList_Append(parts, b);
        Py_DECREF(b);
        len = 0;
        return rc == 0;
    }
};

// int(value) as the Python twin does: fast path for real ints, nb_int
// coercion otherwise
bool as_i64(PyObject* v, int64_t* out) {
    if (PyLong_Check(v)) {
        long long x = PyLong_AsLongLong(v);
        if (x == -1 && PyErr_Occurred()) return false;
        *out = x;
        return true;
    }
    PyObject* n = PyNumber_Long(v);
    if (!n) return false;
    long long x = PyLong_AsLongLong(n);
    Py_DECREF(n);
    if (x == -1 && PyErr_Occurred()) return false;
    *out = x;
    return true;
}

// _bytes_view twin: a flat byte view of a bytes-ish value, plus which
// object to append to parts for the zero-copy path (the original when
// it is itself a flat byte buffer, a flattened copy otherwise).
struct BytesView {
    Py_buffer view{};
    PyObject* flat = nullptr;  // owned flattened copy, when needed
    bool have_view = false;

    ~BytesView() {
        if (have_view) PyBuffer_Release(&view);
        Py_XDECREF(flat);
    }
    bool acquire(PyObject* v) {
        if (PyObject_GetBuffer(v, &view, PyBUF_SIMPLE) == 0) {
            have_view = true;
            return true;
        }
        // non-contiguous exporter: flatten, as bytes(value) would
        PyErr_Clear();
        flat = PyBytes_FromObject(v);
        if (!flat) return false;
        if (PyObject_GetBuffer(flat, &view, PyBUF_SIMPLE) != 0) return false;
        have_view = true;
        return true;
    }
    // the object whose bytes equal the view, safe to hand to sendmsg /
    // ring writers as its own iovec part
    PyObject* part_obj(PyObject* v) const {
        if (flat) return flat;
        if (PyBytes_Check(v) || PyByteArray_Check(v)) return v;
        if (PyMemoryView_Check(v)) {
            const Py_buffer* b = PyMemoryView_GET_BUFFER(v);
            if (b->itemsize == 1 && b->ndim == 1) return v;
        }
        return nullptr;  // exotic exporter: caller copies
    }
};

bool write_bytes_field(Enc* e, PyObject* v) {
    BytesView bv;
    if (!bv.acquire(v)) return false;
    Py_ssize_t n = bv.view.len;
    if (!e->u32(static_cast<uint32_t>(n))) return false;
    if (n >= g_inline_max) {
        if (!e->flush()) return false;
        PyObject* part = bv.part_obj(v);
        if (part != nullptr) {
            if (PyList_Append(e->parts, part) != 0) return false;
        } else {
            PyObject* copy = PyBytes_FromStringAndSize(
                static_cast<const char*>(bv.view.buf), n);
            if (!copy) return false;
            int rc = PyList_Append(e->parts, copy);
            Py_DECREF(copy);
            if (rc != 0) return false;
        }
        return true;
    }
    return e->put(bv.view.buf, n);
}

bool write_field(Enc* e, PyObject* name, PyObject* v, int kind) {
    switch (kind) {
        case K_I64: {
            int64_t x;
            if (!as_i64(v, &x)) return false;
            return e->i64(x);
        }
        case K_BYTES:
            return write_bytes_field(e, v);
        case K_LIST: {
            PyObject* seq = PySequence_Fast(v, "i64-list field not iterable");
            if (!seq) return false;
            Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
            if (n > 65535) {
                Py_DECREF(seq);
                PyErr_Format(PyExc_ValueError,
                             "list field %U overflows u16 bound", name);
                return false;
            }
            if (!e->u16(static_cast<uint16_t>(n))) {
                Py_DECREF(seq);
                return false;
            }
            PyObject** items = PySequence_Fast_ITEMS(seq);
            for (Py_ssize_t i = 0; i < n; i++) {
                int64_t x;
                if (!as_i64(items[i], &x) || !e->i64(x)) {
                    Py_DECREF(seq);
                    return false;
                }
            }
            Py_DECREF(seq);
            return true;
        }
        case K_F64: {
            double x = PyFloat_AsDouble(v);
            if (x == -1.0 && PyErr_Occurred()) return false;
            return e->f64(x);
        }
        case K_BLIST: {
            PyObject* seq = PySequence_Fast(v, "bytes-list field not iterable");
            if (!seq) return false;
            Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
            if (n > 65535) {
                Py_DECREF(seq);
                PyErr_Format(PyExc_ValueError,
                             "blist field %U overflows u16 bound", name);
                return false;
            }
            if (!e->u16(static_cast<uint16_t>(n))) {
                Py_DECREF(seq);
                return false;
            }
            PyObject** items = PySequence_Fast_ITEMS(seq);
            for (Py_ssize_t i = 0; i < n; i++) {
                if (!write_bytes_field(e, items[i])) {
                    Py_DECREF(seq);
                    return false;
                }
            }
            Py_DECREF(seq);
            return true;
        }
        case K_FLIST: {
            PyObject* seq = PySequence_Fast(v, "f64-list field not iterable");
            if (!seq) return false;
            Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
            if (n > 65535) {
                Py_DECREF(seq);
                PyErr_Format(PyExc_ValueError,
                             "flist field %U overflows u16 bound", name);
                return false;
            }
            if (!e->u16(static_cast<uint16_t>(n))) {
                Py_DECREF(seq);
                return false;
            }
            PyObject** items = PySequence_Fast_ITEMS(seq);
            for (Py_ssize_t i = 0; i < n; i++) {
                double x = PyFloat_AsDouble(items[i]);
                if (x == -1.0 && PyErr_Occurred()) {
                    Py_DECREF(seq);
                    return false;
                }
                if (!e->f64(x)) {
                    Py_DECREF(seq);
                    return false;
                }
            }
            Py_DECREF(seq);
            return true;
        }
    }
    PyErr_Format(PyExc_ValueError, "bad field kind %d", kind);
    return false;
}

// ---------------------------------------------------------------- reader

struct Dec {
    const uint8_t* p;
    Py_ssize_t len, off;

    bool need(Py_ssize_t n) {
        if (off + n > len) {
            PyErr_SetString(PyExc_ValueError,
                            "truncated binary frame");
            return false;
        }
        return true;
    }
    uint8_t u8() { return p[off++]; }
    uint16_t u16() {
        uint16_t v;
        memcpy(&v, p + off, 2);
        off += 2;
        return v;
    }
    uint32_t u32() {
        uint32_t v;
        memcpy(&v, p + off, 4);
        off += 4;
        return v;
    }
    int32_t i32() {
        int32_t v;
        memcpy(&v, p + off, 4);
        off += 4;
        return v;
    }
    int64_t i64() {
        int64_t v;
        memcpy(&v, p + off, 8);
        off += 8;
        return v;
    }
    double f64() {
        double v;
        memcpy(&v, p + off, 8);
        off += 8;
        return v;
    }
};

// one field's VALUE (already past fid/kind); returns new ref or NULL
PyObject* read_value(Dec* d, int kind) {
    switch (kind) {
        case K_I64:
            if (!d->need(8)) return nullptr;
            return PyLong_FromLongLong(d->i64());
        case K_BYTES: {
            if (!d->need(4)) return nullptr;
            uint32_t n = d->u32();
            if (!d->need(n)) {
                PyErr_SetString(PyExc_ValueError,
                                "truncated bytes field in binary frame");
                return nullptr;
            }
            PyObject* b = PyBytes_FromStringAndSize(
                reinterpret_cast<const char*>(d->p + d->off), n);
            d->off += n;
            return b;
        }
        case K_LIST: {
            if (!d->need(2)) return nullptr;
            uint16_t cnt = d->u16();
            if (!d->need(static_cast<Py_ssize_t>(cnt) * 8)) return nullptr;
            PyObject* out = PyList_New(cnt);
            if (!out) return nullptr;
            for (uint16_t i = 0; i < cnt; i++) {
                PyObject* x = PyLong_FromLongLong(d->i64());
                if (!x) {
                    Py_DECREF(out);
                    return nullptr;
                }
                PyList_SET_ITEM(out, i, x);
            }
            return out;
        }
        case K_F64:
            if (!d->need(8)) return nullptr;
            return PyFloat_FromDouble(d->f64());
        case K_BLIST: {
            if (!d->need(2)) return nullptr;
            uint16_t cnt = d->u16();
            PyObject* out = PyList_New(cnt);
            if (!out) return nullptr;
            for (uint16_t i = 0; i < cnt; i++) {
                if (!d->need(4)) {
                    Py_DECREF(out);
                    return nullptr;
                }
                uint32_t n = d->u32();
                if (!d->need(n)) {
                    PyErr_SetString(
                        PyExc_ValueError,
                        "truncated blist item in binary frame");
                    Py_DECREF(out);
                    return nullptr;
                }
                PyObject* b = PyBytes_FromStringAndSize(
                    reinterpret_cast<const char*>(d->p + d->off), n);
                d->off += n;
                if (!b) {
                    Py_DECREF(out);
                    return nullptr;
                }
                PyList_SET_ITEM(out, i, b);
            }
            return out;
        }
        case K_FLIST: {
            if (!d->need(2)) return nullptr;
            uint16_t cnt = d->u16();
            if (!d->need(static_cast<Py_ssize_t>(cnt) * 8)) return nullptr;
            PyObject* out = PyList_New(cnt);
            if (!out) return nullptr;
            for (uint16_t i = 0; i < cnt; i++) {
                PyObject* x = PyFloat_FromDouble(d->f64());
                if (!x) {
                    Py_DECREF(out);
                    return nullptr;
                }
                PyList_SET_ITEM(out, i, x);
            }
            return out;
        }
    }
    PyErr_Format(PyExc_ValueError, "bad field kind %d", kind);
    return nullptr;
}

}  // namespace

// ------------------------------------------------------------- entrypoints

namespace {

// protocol objects handed over by codec.py at setup
PyObject* g_wire_tag = nullptr;      // dict Tag -> int
PyObject* g_tag_by_wire[2048];       // wire id -> Tag member (owned)
PyObject* g_msg_cls = nullptr;       // adlb_tpu_torch.runtime.messages.Msg
PyObject* g_s_tag = nullptr;         // interned "tag"/"src"/"data"/"hang"
PyObject* g_s_src = nullptr;
PyObject* g_s_data = nullptr;
PyObject* g_s_hang = nullptr;

// fields: dict name -> (fid, kind); inline_max: codec.py IOV_INLINE_MAX.
// Idempotent (re-setup replaces the tables); returns 0 / -1.
int setup_tables(PyObject* fields, int inline_max) {
    PyObject* ids = PyDict_New();
    if (!ids) return -1;
    for (auto& fi : g_by_fid) {
        Py_CLEAR(fi.name);
        fi.kind = -1;
    }
    PyObject *key, *val;
    Py_ssize_t pos = 0;
    while (PyDict_Next(fields, &pos, &key, &val)) {
        long fid = PyLong_AsLong(PyTuple_GET_ITEM(val, 0));
        long kind = PyLong_AsLong(PyTuple_GET_ITEM(val, 1));
        if ((fid == -1 || kind == -1) && PyErr_Occurred()) {
            Py_DECREF(ids);
            return -1;
        }
        PyObject* packed = PyLong_FromLong((fid << 8) | kind);
        if (!packed || PyDict_SetItem(ids, key, packed) != 0) {
            Py_XDECREF(packed);
            Py_DECREF(ids);
            return -1;
        }
        Py_DECREF(packed);
        if (fid >= 0 && fid < 256) {
            Py_INCREF(key);
            g_by_fid[fid].name = key;
            g_by_fid[fid].kind = static_cast<int>(kind);
        }
    }
    Py_XDECREF(g_field_ids);
    g_field_ids = ids;
    g_inline_max = inline_max;
    return 0;
}

// encode_binary_iov twin: (wire_tag, src, data dict) -> parts list whose
// concatenation is the frame body; big bytes values ride as their own
// zero-copy parts.
PyObject* encode_iov_raw(int wire_tag, int src, PyObject* data) {
    Enc e{nullptr, 0, 0, nullptr};
    e.parts = PyList_New(0);
    if (!e.parts) return nullptr;

    // nfields must land in the header before any field is streamed, so
    // count the non-None fields first (PyDict_Next is two pointer reads
    // per entry — cheaper than patching across already-sealed parts)
    PyObject *key, *val;
    Py_ssize_t pos = 0;
    Py_ssize_t nfields = 0;
    while (PyDict_Next(data, &pos, &key, &val)) {
        if (val != Py_None) nfields++;
    }

    bool ok = e.u8(0x01) && e.u16(static_cast<uint16_t>(wire_tag)) &&
              e.i32(src) && e.u16(static_cast<uint16_t>(nfields));
    pos = 0;
    while (ok && PyDict_Next(data, &pos, &key, &val)) {
        if (val == Py_None) continue;
        PyObject* packed = PyDict_GetItemWithError(g_field_ids, key);
        if (!packed) {
            if (!PyErr_Occurred()) PyErr_SetObject(PyExc_KeyError, key);
            ok = false;
            break;
        }
        long fk = PyLong_AsLong(packed);
        ok = e.u8(static_cast<uint8_t>(fk >> 8)) &&
             e.u8(static_cast<uint8_t>(fk & 0xff)) &&
             write_field(&e, key, val, static_cast<int>(fk & 0xff));
    }
    if (ok) ok = e.flush();
    PyMem_Free(e.buf);
    if (!ok) {
        Py_DECREF(e.parts);
        return nullptr;
    }
    return e.parts;
}

// decode_binary twin up to Msg construction: body buffer ->
// (wire_tag, src, data dict). Unknown field ids are parsed and
// skipped, exactly like the Python twin.
PyObject* decode_raw(PyObject* body) {
    Py_buffer view;
    if (PyObject_GetBuffer(body, &view, PyBUF_SIMPLE) != 0) return nullptr;
    Dec d{static_cast<const uint8_t*>(view.buf), view.len, 0};
    PyObject* out = nullptr;
    PyObject* dict = nullptr;

    do {
        if (!d.need(9)) break;
        uint8_t magic = d.u8();
        if (magic != 0x01) {
            PyErr_Format(PyExc_ValueError, "bad binary frame magic %#x",
                         magic);
            break;
        }
        uint16_t tag = d.u16();
        int32_t src = d.i32();
        uint16_t nfields = d.u16();
        dict = PyDict_New();
        if (!dict) break;
        bool ok = true;
        for (uint16_t i = 0; ok && i < nfields; i++) {
            if (!d.need(2)) {
                ok = false;
                break;
            }
            uint8_t fid = d.u8();
            uint8_t kind = d.u8();
            PyObject* value = read_value(&d, kind);
            if (!value) {
                ok = false;
                break;
            }
            // unknown fields are skipped, not fatal; a KNOWN fid is
            // stored under its name whatever kind it arrived as — the
            // Python twin's exact rule (FIELD_FOR_WIRE.get, no kind
            // cross-check), kept bug-for-bug so the fuzz can hold the
            // twins identical
            const FieldInfo& fi = g_by_fid[fid];
            if (fi.name != nullptr) {
                ok = PyDict_SetItem(dict, fi.name, value) == 0;
            }
            Py_DECREF(value);
        }
        if (!ok) break;
        out = Py_BuildValue("(iiN)", static_cast<int>(tag),
                            static_cast<int>(src), dict);
        dict = nullptr;  // reference stolen by N
    } while (false);

    Py_XDECREF(dict);
    PyBuffer_Release(&view);
    return out;
}

// ------------------------------------------------- Python-callable layer
//
// The .so is NOT an importable extension module: build.py dlopens it
// with ctypes.PyDLL (the wqcore loading discipline) and calls
// adlb_codec_module() ONCE, which hands back a real module object whose
// functions are METH_FASTCALL builtins — per-frame calls then cost a
// builtin vector call, not a ctypes FFI marshal (measured ~3x the
// difference on small frames).

PyObject* py_setup(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
    // (fields, inline_max, wire_tag: dict Tag->int,
    //  tag_for_wire: dict int->Tag, msg_cls)
    if (nargs != 5) {
        PyErr_SetString(PyExc_TypeError, "setup expects 5 arguments");
        return nullptr;
    }
    long inline_max = PyLong_AsLong(args[1]);
    if (inline_max == -1 && PyErr_Occurred()) return nullptr;
    if (setup_tables(args[0], static_cast<int>(inline_max)) != 0)
        return nullptr;
    Py_XDECREF(g_wire_tag);
    g_wire_tag = args[2];
    Py_INCREF(g_wire_tag);
    for (auto& t : g_tag_by_wire) Py_CLEAR(t);
    PyObject *key, *val;
    Py_ssize_t pos = 0;
    while (PyDict_Next(args[3], &pos, &key, &val)) {
        long wire = PyLong_AsLong(key);
        if (wire == -1 && PyErr_Occurred()) return nullptr;
        if (wire >= 0 && wire < 2048) {
            Py_INCREF(val);
            g_tag_by_wire[wire] = val;
        }
    }
    Py_XDECREF(g_msg_cls);
    g_msg_cls = args[4];
    Py_INCREF(g_msg_cls);
    if (!g_s_tag) {
        g_s_tag = PyUnicode_InternFromString("tag");
        g_s_src = PyUnicode_InternFromString("src");
        g_s_data = PyUnicode_InternFromString("data");
        g_s_hang = PyUnicode_InternFromString("hang");
        if (!g_s_tag || !g_s_src || !g_s_data || !g_s_hang) return nullptr;
    }
    Py_RETURN_NONE;
}

bool ready() {
    if (!g_field_ids || !g_wire_tag || !g_msg_cls) {
        PyErr_SetString(PyExc_RuntimeError, "_adlbcodec.setup not called");
        return false;
    }
    return true;
}

// encode_iov(m: Msg) -> list of body parts
PyObject* py_encode_iov(PyObject*, PyObject* m) {
    if (!ready()) return nullptr;
    PyObject* tag = PyObject_GetAttr(m, g_s_tag);
    if (!tag) return nullptr;
    PyObject* wire = PyDict_GetItemWithError(g_wire_tag, tag);
    if (!wire) {
        if (!PyErr_Occurred()) PyErr_SetObject(PyExc_KeyError, tag);
        Py_DECREF(tag);
        return nullptr;
    }
    Py_DECREF(tag);
    long wire_tag = PyLong_AsLong(wire);
    PyObject* srco = PyObject_GetAttr(m, g_s_src);
    if (!srco) return nullptr;
    long src = PyLong_AsLong(srco);
    Py_DECREF(srco);
    if (src == -1 && PyErr_Occurred()) return nullptr;
    PyObject* data = PyObject_GetAttr(m, g_s_data);
    if (!data) return nullptr;
    if (!PyDict_Check(data)) {
        Py_DECREF(data);
        PyErr_SetString(PyExc_TypeError, "Msg.data must be a dict");
        return nullptr;
    }
    PyObject* out = encode_iov_raw(static_cast<int>(wire_tag),
                                   static_cast<int>(src), data);
    Py_DECREF(data);
    return out;
}

// decode(body) -> Msg
PyObject* py_decode(PyObject*, PyObject* body) {
    if (!ready()) return nullptr;
    PyObject* triple = decode_raw(body);
    if (!triple) return nullptr;
    long wire = PyLong_AsLong(PyTuple_GET_ITEM(triple, 0));
    PyObject* tag = (wire >= 0 && wire < 2048) ? g_tag_by_wire[wire]
                                               : nullptr;
    if (!tag) {
        PyErr_SetObject(PyExc_KeyError, PyTuple_GET_ITEM(triple, 0));
        Py_DECREF(triple);
        return nullptr;
    }
    PyObject* data = PyTuple_GET_ITEM(triple, 2);
    // protocol-level convenience, the Python twin's exact rule:
    // hang arrives as 0/1, delivered as bool
    PyObject* hang = PyDict_GetItemWithError(data, g_s_hang);
    if (hang) {
        int truth = PyObject_IsTrue(hang);
        if (truth < 0 ||
            PyDict_SetItem(data, g_s_hang, truth ? Py_True : Py_False) != 0) {
            Py_DECREF(triple);
            return nullptr;
        }
    } else if (PyErr_Occurred()) {
        Py_DECREF(triple);
        return nullptr;
    }
    PyObject* m = PyObject_CallFunctionObjArgs(
        g_msg_cls, tag, PyTuple_GET_ITEM(triple, 1), data, nullptr);
    Py_DECREF(triple);
    return m;
}

PyMethodDef codec_methods[] = {
    {"setup", reinterpret_cast<PyCFunction>(
                  reinterpret_cast<void*>(py_setup)),
     METH_FASTCALL,
     "setup(fields, inline_max, wire_tag, tag_for_wire, msg_cls)"},
    {"encode_iov", py_encode_iov, METH_O,
     "scatter-gather TLV encode of a Msg -> list of body parts"},
    {"decode", py_decode, METH_O, "TLV body -> Msg"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef codec_moddef = {
    PyModuleDef_HEAD_INIT, "_adlbcodec",
    "compiled TLV wire codec (see adlb_tpu_torch/native/codec.cpp)", -1,
    codec_methods, nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

extern "C" {

// the single ctypes entrypoint: a fully-formed module object (new ref)
PyObject* adlb_codec_module() { return PyModule_Create(&codec_moddef); }

}  // extern "C"
