/* _fastio: asynchronous streaming NetCDF-3 record writer
 * (climt_tpu_torch's own copy of climt_tpu/io/_fastio.c).
 *
 * The hot path of model output is appending one record (a time slice of
 * every stored variable) per store call.  This extension owns that data
 * path in C:
 *
 *   - the Python side (io/native.py) builds the NetCDF classic header
 *     once and hands records over as contiguous native-endian f8 buffers;
 *   - a dedicated pthread drains a bounded queue, byte-swaps to the
 *     big-endian on-disk order, and appends; the GIL is released at
 *     enqueue time and never held by the writer thread;
 *   - numrecs in the header stays at STREAMING (0xFFFFFFFF, the netCDF
 *     spec's "compute from file size" sentinel) while open, so a crash
 *     mid-run leaves a readable file; close() finalizes it.
 *
 * The package loads it by path as climt_tpu_torch.io._fastio (the
 * PyInit__fastio symbol below matches the name's last part).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

typedef struct record {
    struct record *next;
    size_t nbytes;
    char data[];                /* native-endian f8 payload */
} record_t;

typedef struct {
    FILE *fp;
    pthread_t thread;
    pthread_mutex_t lock;
    pthread_cond_t cond_nonempty;
    pthread_cond_t cond_drained;
    record_t *head, *tail;
    size_t queued;
    size_t max_queued;          /* backpressure bound */
    long long numrecs;
    int closing;
    int io_error;
} writer_t;

static void enqueue_locked(writer_t *w, record_t *r)
{
    if (w->tail) w->tail->next = r; else w->head = r;
    w->tail = r;
    w->queued++;
}

static record_t *dequeue_locked(writer_t *w)
{
    record_t *r = w->head;
    if (r) {
        w->head = r->next;
        if (!w->head) w->tail = NULL;
        w->queued--;
    }
    return r;
}

static void write_swapped(writer_t *w, const char *data, size_t nbytes)
{
    /* byteswap f8 native(LE) -> big-endian in 64 KB chunks */
    char buf[65536];
    size_t i = 0;
    while (i < nbytes) {
        size_t n = nbytes - i;
        if (n > sizeof(buf)) n = sizeof(buf);
        for (size_t j = 0; j + 8 <= n; j += 8) {
            const char *s = data + i + j;
            char *d = buf + j;
            d[0] = s[7]; d[1] = s[6]; d[2] = s[5]; d[3] = s[4];
            d[4] = s[3]; d[5] = s[2]; d[6] = s[1]; d[7] = s[0];
        }
        if (fwrite(buf, 1, n, w->fp) != n) {
            w->io_error = 1;
            return;
        }
        i += n;
    }
}

static void *writer_main(void *arg)
{
    writer_t *w = (writer_t *)arg;
    for (;;) {
        pthread_mutex_lock(&w->lock);
        while (!w->head && !w->closing)
            pthread_cond_wait(&w->cond_nonempty, &w->lock);
        record_t *r = dequeue_locked(w);
        if (!r && w->closing) {
            pthread_mutex_unlock(&w->lock);
            break;
        }
        pthread_mutex_unlock(&w->lock);
        if (r) {
            if (!w->io_error) {
                write_swapped(w, r->data, r->nbytes);
                w->numrecs++;
            }
            PyMem_RawFree(r);
            pthread_mutex_lock(&w->lock);
            if (!w->queued)
                pthread_cond_broadcast(&w->cond_drained);
            pthread_mutex_unlock(&w->lock);
        }
    }
    fflush(w->fp);
    return NULL;
}

static void writer_capsule_destructor(PyObject *capsule);

static writer_t *get_writer(PyObject *capsule)
{
    writer_t *w = (writer_t *)PyCapsule_GetPointer(capsule, "_fastio.writer");
    if (!w) return NULL;
    return w;
}

/* open(filename: str, header: bytes) -> capsule */
static PyObject *fastio_open(PyObject *self, PyObject *args)
{
    const char *filename;
    Py_buffer header;
    if (!PyArg_ParseTuple(args, "sy*", &filename, &header))
        return NULL;
    FILE *fp = fopen(filename, "wb");
    if (!fp) {
        PyBuffer_Release(&header);
        return PyErr_SetFromErrnoWithFilename(PyExc_OSError, filename);
    }
    if (fwrite(header.buf, 1, (size_t)header.len, fp)
            != (size_t)header.len) {
        fclose(fp);
        PyBuffer_Release(&header);
        PyErr_SetString(PyExc_OSError, "short header write");
        return NULL;
    }
    fflush(fp);
    PyBuffer_Release(&header);

    writer_t *w = (writer_t *)PyMem_RawCalloc(1, sizeof(writer_t));
    if (!w) { fclose(fp); return PyErr_NoMemory(); }
    w->fp = fp;
    w->max_queued = 64;
    pthread_mutex_init(&w->lock, NULL);
    pthread_cond_init(&w->cond_nonempty, NULL);
    pthread_cond_init(&w->cond_drained, NULL);
    if (pthread_create(&w->thread, NULL, writer_main, w) != 0) {
        fclose(fp);
        PyMem_RawFree(w);
        PyErr_SetString(PyExc_OSError, "cannot start writer thread");
        return NULL;
    }
    return PyCapsule_New(w, "_fastio.writer", writer_capsule_destructor);
}

/* append(capsule, buffer) — enqueue one record (native f8 bytes) */
static PyObject *fastio_append(PyObject *self, PyObject *args)
{
    PyObject *capsule;
    Py_buffer buf;
    if (!PyArg_ParseTuple(args, "Oy*", &capsule, &buf))
        return NULL;
    writer_t *w = get_writer(capsule);
    if (!w) { PyBuffer_Release(&buf); return NULL; }
    if (w->io_error) {
        PyBuffer_Release(&buf);
        PyErr_SetString(PyExc_OSError, "writer thread hit an IO error");
        return NULL;
    }
    record_t *r = (record_t *)PyMem_RawMalloc(sizeof(record_t)
                                              + (size_t)buf.len);
    if (!r) { PyBuffer_Release(&buf); return PyErr_NoMemory(); }
    r->next = NULL;
    r->nbytes = (size_t)buf.len;
    memcpy(r->data, buf.buf, (size_t)buf.len);
    PyBuffer_Release(&buf);

    Py_BEGIN_ALLOW_THREADS
    pthread_mutex_lock(&w->lock);
    while (w->queued >= w->max_queued)          /* backpressure */
        pthread_cond_wait(&w->cond_drained, &w->lock);
    enqueue_locked(w, r);
    pthread_cond_signal(&w->cond_nonempty);
    pthread_mutex_unlock(&w->lock);
    Py_END_ALLOW_THREADS
    Py_RETURN_NONE;
}

/* flush(capsule) — block until the queue is drained and fflush */
static PyObject *fastio_flush(PyObject *self, PyObject *args)
{
    PyObject *capsule;
    if (!PyArg_ParseTuple(args, "O", &capsule))
        return NULL;
    writer_t *w = get_writer(capsule);
    if (!w) return NULL;
    Py_BEGIN_ALLOW_THREADS
    pthread_mutex_lock(&w->lock);
    while (w->queued)
        pthread_cond_wait(&w->cond_drained, &w->lock);
    pthread_mutex_unlock(&w->lock);
    fflush(w->fp);
    Py_END_ALLOW_THREADS
    if (w->io_error) {
        PyErr_SetString(PyExc_OSError, "writer thread hit an IO error");
        return NULL;
    }
    return PyLong_FromLongLong(w->numrecs);
}

static void close_writer(writer_t *w, int finalize_numrecs)
{
    pthread_mutex_lock(&w->lock);
    w->closing = 1;
    pthread_cond_broadcast(&w->cond_nonempty);
    pthread_mutex_unlock(&w->lock);
    pthread_join(w->thread, NULL);
    if (finalize_numrecs && !w->io_error && w->numrecs >= 0) {
        /* patch numrecs (bytes 4..7, big-endian) from STREAMING */
        uint32_t n = (uint32_t)w->numrecs;
        unsigned char be[4] = {
            (unsigned char)(n >> 24), (unsigned char)(n >> 16),
            (unsigned char)(n >> 8), (unsigned char)n };
        fseek(w->fp, 4, SEEK_SET);
        fwrite(be, 1, 4, w->fp);
    }
    fclose(w->fp);
    pthread_mutex_destroy(&w->lock);
    pthread_cond_destroy(&w->cond_nonempty);
    pthread_cond_destroy(&w->cond_drained);
}

/* close(capsule) -> numrecs */
static PyObject *fastio_close(PyObject *self, PyObject *args)
{
    PyObject *capsule;
    if (!PyArg_ParseTuple(args, "O", &capsule))
        return NULL;
    writer_t *w = get_writer(capsule);
    if (!w) return NULL;
    long long numrecs;
    Py_BEGIN_ALLOW_THREADS
    close_writer(w, 1);
    Py_END_ALLOW_THREADS
    numrecs = w->numrecs;
    int err = w->io_error;
    PyMem_RawFree(w);
    PyCapsule_SetPointer(capsule, (void *)1);   /* poison */
    PyCapsule_SetName(capsule, "_fastio.closed");
    if (err) {
        PyErr_SetString(PyExc_OSError, "writer thread hit an IO error");
        return NULL;
    }
    return PyLong_FromLongLong(numrecs);
}

static void writer_capsule_destructor(PyObject *capsule)
{
    if (strcmp(PyCapsule_GetName(capsule), "_fastio.writer") != 0)
        return;                 /* already closed explicitly */
    writer_t *w = (writer_t *)PyCapsule_GetPointer(capsule,
                                                   "_fastio.writer");
    if (w) {
        close_writer(w, 1);
        PyMem_RawFree(w);
    }
}

static PyMethodDef fastio_methods[] = {
    {"open", fastio_open, METH_VARARGS,
     "open(filename, header_bytes) -> writer capsule"},
    {"append", fastio_append, METH_VARARGS,
     "append(writer, record_bytes): enqueue one record (async)"},
    {"flush", fastio_flush, METH_VARARGS,
     "flush(writer) -> numrecs: drain the queue and fflush"},
    {"close", fastio_close, METH_VARARGS,
     "close(writer) -> numrecs: drain, finalize numrecs, close"},
    {NULL, NULL, 0, NULL}
};

static struct PyModuleDef fastio_module = {
    PyModuleDef_HEAD_INIT, "_fastio",
    "Async streaming NetCDF-3 record writer (C, GIL-free IO path)",
    -1, fastio_methods
};

PyMODINIT_FUNC PyInit__fastio(void)
{
    return PyModule_Create(&fastio_module);
}
