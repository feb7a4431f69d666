/* _ringlog — mmap-backed fixed-frame ring buffer for trajectory streaming.
 *
 * Native replacement for the reference's pickle episode recorder
 * (nightmare_rl envs/nightmare_v3_env.py:261-272): the training loop streams
 * device->host state frames at rollout rate; this sink appends fixed-size
 * frames into a crash-safe memory-mapped ring file with O(1) cost and no
 * serialization, so recording never stalls the hot loop.  The replayer reads
 * the frames back in order.
 *
 * File layout: 4096-byte header (magic, version, frame_size, capacity,
 * head = total frames ever written) followed by capacity * frame_size bytes.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <fcntl.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#define RL_MAGIC 0x52494e47u /* "RING" */
#define RL_VERSION 1u
#define RL_HEADER 4096

typedef struct {
    uint32_t magic;
    uint32_t version;
    uint64_t frame_size;
    uint64_t capacity;
    uint64_t head; /* total frames written (monotonic) */
} rl_header;

typedef struct {
    PyObject_HEAD
    int fd;
    size_t map_size;
    uint8_t *map;
} RingLog;

static rl_header *rl_hdr(RingLog *self) { return (rl_header *)self->map; }

static int RingLog_init(RingLog *self, PyObject *args, PyObject *kwds) {
    const char *path;
    unsigned long long frame_size = 0, capacity = 0;
    static char *kwlist[] = {"path", "frame_size", "capacity", NULL};
    if (!PyArg_ParseTupleAndKeywords(args, kwds, "s|KK", kwlist, &path,
                                     &frame_size, &capacity))
        return -1;

    self->fd = open(path, O_RDWR | O_CREAT, 0644);
    if (self->fd < 0) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return -1;
    }
    struct stat st;
    if (fstat(self->fd, &st) != 0) {
        PyErr_SetFromErrno(PyExc_OSError);
        return -1;
    }
    if (st.st_size >= (off_t)RL_HEADER && frame_size == 0) {
        /* open existing: read geometry from the header */
        rl_header hdr;
        if (pread(self->fd, &hdr, sizeof hdr, 0) != sizeof hdr ||
            hdr.magic != RL_MAGIC) {
            PyErr_SetString(PyExc_ValueError, "not a ringlog file");
            return -1;
        }
        frame_size = hdr.frame_size;
        capacity = hdr.capacity;
    }
    if (frame_size == 0 || capacity == 0) {
        PyErr_SetString(PyExc_ValueError,
                        "frame_size and capacity required for a new file");
        return -1;
    }
    self->map_size = RL_HEADER + (size_t)frame_size * capacity;
    if (ftruncate(self->fd, (off_t)self->map_size) != 0) {
        PyErr_SetFromErrno(PyExc_OSError);
        return -1;
    }
    self->map = mmap(NULL, self->map_size, PROT_READ | PROT_WRITE, MAP_SHARED,
                     self->fd, 0);
    if (self->map == MAP_FAILED) {
        self->map = NULL;
        PyErr_SetFromErrno(PyExc_OSError);
        return -1;
    }
    rl_header *h = rl_hdr(self);
    if (h->magic != RL_MAGIC) {
        memset(self->map, 0, RL_HEADER);
        h->magic = RL_MAGIC;
        h->version = RL_VERSION;
        h->frame_size = frame_size;
        h->capacity = capacity;
        h->head = 0;
    }
    return 0;
}

static void RingLog_dealloc(RingLog *self) {
    if (self->map) munmap(self->map, self->map_size);
    if (self->fd >= 0) close(self->fd);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyObject *RingLog_append(RingLog *self, PyObject *arg) {
    Py_buffer buf;
    if (PyObject_GetBuffer(arg, &buf, PyBUF_SIMPLE) != 0) return NULL;
    rl_header *h = rl_hdr(self);
    if ((uint64_t)buf.len != h->frame_size) {
        PyBuffer_Release(&buf);
        PyErr_Format(PyExc_ValueError, "frame must be %llu bytes, got %zd",
                     (unsigned long long)h->frame_size, buf.len);
        return NULL;
    }
    uint64_t slot = h->head % h->capacity;
    memcpy(self->map + RL_HEADER + slot * h->frame_size, buf.buf, buf.len);
    h->head += 1;
    PyBuffer_Release(&buf);
    Py_RETURN_NONE;
}

static PyObject *RingLog_read_all(RingLog *self, PyObject *ignored) {
    rl_header *h = rl_hdr(self);
    uint64_t n = h->head < h->capacity ? h->head : h->capacity;
    uint64_t start = h->head < h->capacity ? 0 : h->head % h->capacity;
    PyObject *out = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)(n * h->frame_size));
    if (!out) return NULL;
    char *dst = PyBytes_AS_STRING(out);
    for (uint64_t i = 0; i < n; i++) {
        uint64_t slot = (start + i) % h->capacity;
        memcpy(dst + i * h->frame_size,
               self->map + RL_HEADER + slot * h->frame_size, h->frame_size);
    }
    return out;
}

static PyObject *RingLog_flush(RingLog *self, PyObject *ignored) {
    if (msync(self->map, self->map_size, MS_ASYNC) != 0)
        return PyErr_SetFromErrno(PyExc_OSError);
    Py_RETURN_NONE;
}

static PyObject *RingLog_get(RingLog *self, void *which) {
    rl_header *h = rl_hdr(self);
    switch ((intptr_t)which) {
    case 0: return PyLong_FromUnsignedLongLong(h->head);
    case 1: return PyLong_FromUnsignedLongLong(h->frame_size);
    default: return PyLong_FromUnsignedLongLong(h->capacity);
    }
}

static PyMethodDef RingLog_methods[] = {
    {"append", (PyCFunction)RingLog_append, METH_O,
     "Append one frame (buffer of exactly frame_size bytes)."},
    {"read_all", (PyCFunction)RingLog_read_all, METH_NOARGS,
     "Return the retained frames, oldest first, as bytes."},
    {"flush", (PyCFunction)RingLog_flush, METH_NOARGS, "msync the mapping."},
    {NULL, NULL, 0, NULL}};

static PyGetSetDef RingLog_getset[] = {
    {"head", (getter)RingLog_get, NULL, "total frames written", (void *)0},
    {"frame_size", (getter)RingLog_get, NULL, NULL, (void *)1},
    {"capacity", (getter)RingLog_get, NULL, NULL, (void *)2},
    {NULL}};

static PyTypeObject RingLogType = {
    PyVarObject_HEAD_INIT(NULL, 0).tp_name = "_ringlog.RingLog",
    .tp_basicsize = sizeof(RingLog),
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_new = PyType_GenericNew,
    .tp_init = (initproc)RingLog_init,
    .tp_dealloc = (destructor)RingLog_dealloc,
    .tp_methods = RingLog_methods,
    .tp_getset = RingLog_getset,
    .tp_doc = "mmap-backed fixed-frame ring buffer",
};

static PyModuleDef ringlog_module = {
    PyModuleDef_HEAD_INIT, "_ringlog",
    "mmap ring-buffer trajectory sink (native)", -1, NULL};

PyMODINIT_FUNC PyInit__ringlog(void) {
    PyObject *m;
    if (PyType_Ready(&RingLogType) < 0) return NULL;
    m = PyModule_Create(&ringlog_module);
    if (!m) return NULL;
    Py_INCREF(&RingLogType);
    PyModule_AddObject(m, "RingLog", (PyObject *)&RingLogType);
    return m;
}
